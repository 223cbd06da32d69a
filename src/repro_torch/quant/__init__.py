"""``repro_torch.quant`` -- post-training quantization of the port.

Quantize once (:func:`quantize_model` with calibration, or
:func:`quantize_vision` for weight-only), then serve many: the quantized
model drops into ``VisionEngine``, which flips its policy to
``precision="int8"`` so every conv runs the int8 implicit-im2col kernel
and the dense head the int8 GeMM (calibrated), or the float kernels on
dequantized weights and the weight-only GeMM / GEMV (weight-only).  An LM
quantized by :func:`quantize_lm_weights` (int8 or packed int4, weight-
only) drops into ``serve.ServeEngine`` the same way: its projections run
the weight-only int8 or the int4 GeMM / GEMV; an fp8 one runs the e4m3
GeMM under ``precision="fp8"``.  :func:`quantize_lm` calibrates an LM's
activation scales too, so its int8 model serves int8 x int8 on the int8
GeMM (and its fp8 model quantizes activations to e4m3).  Under
``precision="float"`` or ``backend="torch"`` a quantized weight
dequantizes onto the float path.

Port of ``repro.quant``.
"""
from repro_torch.quant.calibrate import (
    Calibration,
    MinMaxObserver,
    OBSERVERS,
    PercentileObserver,
    calibration,
    current_calibration,
)
from repro_torch.quant.ptq import (LM_WEIGHT_KEYS, lm_calibration_forward,
                                   quantize_lm, quantize_lm_weights,
                                   quantize_model, quantize_vision)
from repro_torch.quant.qtensor import (
    FP8_DTYPE,
    FP8_MAX,
    QuantizedTensor,
    QuantizedWeight,
    dequantize,
    is_quantized,
    pack_int4,
    quantize_activation,
    quantize_weight,
    to_fp8,
    unpack_int4,
)

__all__ = [
    "Calibration",
    "FP8_DTYPE",
    "FP8_MAX",
    "LM_WEIGHT_KEYS",
    "MinMaxObserver",
    "OBSERVERS",
    "PercentileObserver",
    "QuantizedTensor",
    "QuantizedWeight",
    "calibration",
    "current_calibration",
    "dequantize",
    "is_quantized",
    "lm_calibration_forward",
    "pack_int4",
    "quantize_activation",
    "quantize_lm",
    "quantize_lm_weights",
    "quantize_model",
    "quantize_vision",
    "quantize_weight",
    "to_fp8",
    "unpack_int4",
]
