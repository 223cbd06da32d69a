"""Gradient compression: per-tensor symmetric int8 quantization with an
error-feedback residual carried across steps (port of
``repro.optim.compression``).

The quantization error is added back to the next step's gradient, so the
accumulated update is unbiased.  The reference's ``compressed_psum`` (an
int8 all-reduce across data-parallel replicas) needs a process group and
comes with sharding.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 payload, float32 scale): ``max|x| / 127`` (at least 1e-12),
    the values rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads: dict[str, torch.Tensor],
                           error: dict[str, torch.Tensor]
                           ) -> tuple[dict, dict]:
    """-> (compressed grads, new error); ``error`` has ``grads``' keys."""
    comp, err = {}, {}
    for name, g in grads.items():
        corrected = g.float() + error[name]
        dq = dequantize_int8(*quantize_int8(corrected))
        comp[name] = dq.to(g.dtype)
        err[name] = corrected - dq
    return comp, err


def init_error(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A zero float32 residual for each tensor of ``params``."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
