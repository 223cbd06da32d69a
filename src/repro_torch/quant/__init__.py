"""``repro_torch.quant`` -- post-training int8 quantization of the port.

Quantize once (:func:`quantize_model` with calibration, or
:func:`quantize_vision` for weight-only), then serve many: the quantized
model drops into ``VisionEngine``, which flips its policy to
``precision="int8"`` so every conv runs the int8 implicit-im2col kernel
and the dense head the int8 GeMM (calibrated), or the float kernels on
dequantized weights and the weight-only GeMM / GEMV (weight-only).  Under
``precision="float"`` or ``backend="torch"`` a quantized weight
dequantizes onto the float path.

Port of the vision half of ``repro.quant``.  The int4 and fp8 storage
formats convert and dequantize payload for payload, but their kernel
routes raise "not ported yet"; the LM calibration (``quantize_lm``) comes
with the LM slice.
"""
from repro_torch.quant.calibrate import (
    Calibration,
    MinMaxObserver,
    OBSERVERS,
    PercentileObserver,
    calibration,
    current_calibration,
)
from repro_torch.quant.ptq import quantize_model, quantize_vision
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
    "MinMaxObserver",
    "OBSERVERS",
    "PercentileObserver",
    "QuantizedTensor",
    "QuantizedWeight",
    "calibration",
    "current_calibration",
    "dequantize",
    "is_quantized",
    "pack_int4",
    "quantize_activation",
    "quantize_model",
    "quantize_vision",
    "quantize_weight",
    "to_fp8",
    "unpack_int4",
]
