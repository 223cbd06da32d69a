"""The port's kernels: each module holds a CUDA kernel's wrapper, its plain
PyTorch version and its launch counter (``<wrapper>.launches``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  The sources live in ``csrc/`` and are
built by :mod:`repro_torch.kernels._build` at first launch.

The float kernels take float32 or bfloat16 operands (both operands of a
product in one dtype, as the reference's products take them), widen
bfloat16 to float32 at the load, accumulate in float32 and round once to
the output dtype, float32 or bfloat16.
"""

from __future__ import annotations

import functools

import torch

FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def float_dtype(what: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of ``tensors``, float32 or bfloat16; raise otherwise."""
    dt = tensors[0].dtype
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{what}: the kernel takes both operands of a "
                            f"product in one dtype, got {dt} and {t.dtype}")
    if dt not in FLOAT_DTYPES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, "
                        f"got {dt}")
    return dt


def check_operands(what: str, *tensors: torch.Tensor,
                   dtypes: tuple[torch.dtype, ...] | None = None
                   ) -> torch.device:
    """The common device of ``tensors`` if it is a CUDA device and every
    tensor is a contiguous tensor on it of its dtype in ``dtypes`` (one
    per tensor; None: one float dtype for all, :func:`float_dtype`); raise
    otherwise.  The int8 kernels pass ``torch.int8`` for their payloads."""
    dev = tensors[0].device
    if dtypes is None:
        dtypes = (float_dtype(what, *tensors),) * len(tensors)
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
    return all(t.is_cpu for t in tensors)


def check_out_dtype(what: str, out_dtype,
                    default: torch.dtype = torch.float32) -> torch.dtype:
    """The output dtype a kernel writes: ``out_dtype``, or ``default``
    when it is None; float32 and bfloat16 only."""
    out_dtype = default if out_dtype is None else out_dtype
    if out_dtype not in FLOAT_DTYPES:
        raise TypeError(f"{what}: the kernel writes float32 or bfloat16, "
                        f"got out_dtype={out_dtype}")
    return out_dtype


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once: the split-K
    planners size their grids by it at every launch)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def is_bf16(dtype: torch.dtype) -> int:
    """1 for bfloat16, 0 for float32: the dtype flags of the C entries."""
    return int(dtype == torch.bfloat16)


# per (device, stream): the streaming GEMVs' split-K planes (float32) and
# their column blocks' arrival counters (int32, zero between launches: the
# last CTA of a block resets its own), grown as calls need more; gemv,
# wq_gemv and int4_gemv share them (a stream runs its launches in order)
_split_k_scratch: dict = {}


def split_k_workspace(dev: torch.device, stream: int, planes: int,
                      blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """At least ``planes`` float32 plane values and ``blocks`` zeroed int32
    counters for a launch on ``stream`` of ``dev``; allocated only when a
    call needs more than the stream's workspace holds."""
    key = (dev.index, stream)
    ws = _split_k_scratch.get(key)
    if ws is None or ws[0].numel() < planes or ws[1].numel() < blocks:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(planes, have[0]), dtype=torch.float32,
                          device=dev),
              torch.zeros(max(blocks, have[1]), dtype=torch.int32,
                          device=dev))
        _split_k_scratch[key] = ws
    return ws
