"""Carry the JAX package's parameters into the port.

:func:`params_from_jax` takes the reference's parameter pytree as nested
dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``; this
module imports no JAX) and builds the port's module with the same weights,
so both packages then compute the same function.  A quantized reference
weight arrives as the plain dict ``{"q", "scale", "act_scale", "axis",
"dtype_name", "bits", "pack_size"}`` with numpy children and becomes a
``QuantizedTensor``, so a JAX-quantized and JAX-calibrated pytree runs in
the port unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.qtensor import QuantizedTensor
from repro_torch.vision import blocks as B
from repro_torch.vision.models import ResNet, VisionConfig, _check_ported


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.array(a))


def _weight(a) -> torch.Tensor | QuantizedTensor:
    if isinstance(a, dict):
        return QuantizedTensor.from_numpy(a)
    return _tensor(a)


def _conv(p: dict) -> B.ConvBN:
    return B.ConvBN(_weight(p["w"]), _tensor(p["b"]))


def params_from_jax(tree: dict, cfg: VisionConfig, *,
                    device=None) -> torch.nn.Module:
    """The port's model for ``cfg`` holding the weights of ``tree`` (a
    reference pytree of numpy arrays), on ``device`` (None: CUDA)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    stages = [[B.Bottleneck(_conv(blk["conv1"]), _conv(blk["conv2"]),
                            _conv(blk["conv3"]),
                            _conv(blk["down"]) if "down" in blk else None)
               for blk in stage] for stage in tree["stages"]]
    head = B.Dense(_weight(tree["head"]["w"]), _tensor(tree["head"]["b"]))
    return ResNet(cfg, _conv(tree["stem"]), stages, head).to(dev)
