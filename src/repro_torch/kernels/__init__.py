"""The port's kernels: each module holds a CUDA kernel's wrapper, its plain
PyTorch version and its launch counter (``<wrapper>.launches``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  The sources live in ``csrc/`` and are
built by :mod:`repro_torch.kernels._build` at first launch.
"""

from __future__ import annotations

import torch


def check_operands(what: str, *tensors: torch.Tensor,
                   dtypes: tuple[torch.dtype, ...] | None = None
                   ) -> torch.device:
    """The common device of ``tensors`` if it is a CUDA device and every
    tensor is a contiguous tensor on it of its dtype in ``dtypes`` (one
    per tensor; None: float32 for all, the float kernels); raise
    otherwise.  The int8 kernels pass ``torch.int8`` for their payloads."""
    dev = tensors[0].device
    if dtypes is None:
        dtypes = (torch.float32,) * len(tensors)
    for t, want in zip(tensors, dtypes, strict=True):
        if t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
        if t.dtype != want:
            raise TypeError(f"{what}: the kernel takes {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel runs on CUDA tensors, got {dev}")
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version case)."""
    return all(t.device.type == "cpu" for t in tensors)


def check_out_dtype(what: str, out_dtype) -> None:
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"{what}: the kernel writes float32, "
                        f"got out_dtype={out_dtype}")
