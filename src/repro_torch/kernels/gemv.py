"""Small-batch GEMV ``(B <= 8, K) @ (K, N)``: CUDA kernel and plain version.

Port of ``repro.kernels.gemv.gemv``.  The kernel (``csrc/gemv.cu``) reads
W once with coalesced loads and splits K across CTAs so that a narrow head
still fills the card; see the note at the top of the source.  Operands
are float32 or bfloat16 (one dtype), the output ``out_dtype`` (default
``x.dtype``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_build, check_operands, check_out_dtype,
                                 is_bf16, on_cpu, sm_count)
from repro_torch.kernels.ref import gemv_ref as gemv_plain  # noqa: F401

MAX_BATCH = 8
COLS_PER_CTA = 128     # one column per thread (csrc/gemv.cu kCols)


def split_k(K: int, N: int, sms: int, block_k: int) -> tuple[int, int]:
    """(kc, ksplit): rows of K per CTA and the number of K chunks.

    Enough chunks to put about two CTAs on each of ``sms`` SMs, each chunk
    a multiple of 32 rows and at most ``block_k`` deep."""
    n_col = -(-N // COLS_PER_CTA)
    want = max(1, -(-2 * sms // n_col))
    kc = -(-K // want)
    kc = -(-kc // 32) * 32
    kc = max(1, min(kc, block_k, K))
    return kc, -(-K // kc)


def _entry():
    fn = _build.load("gemv").gemv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemv(x: torch.Tensor, w: torch.Tensor, *, block_k: int = 512,
         out_dtype=None) -> torch.Tensor:
    """``x (B, K) | (K,) @ w (K, N)`` with B <= 8, float32 accumulation.

    ``block_k`` caps the K depth one CTA walks (the reference's K block);
    the wrapper splits K further until the grid covers the card."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    B, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"gemv: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if on_cpu(x, w):
        out = gemv_plain(x, w, out_dtype)
    else:
        out = _launch(x, w, block_k, out_dtype)
    return out[0] if squeeze else out


def _launch(x, w, block_k, out_dtype):
    dev = check_operands("gemv", x, w)
    out_dtype = check_out_dtype("gemv", out_dtype, x.dtype)
    B, K = x.shape
    N = w.shape[1]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"gemv: batch {B} outside 1..{MAX_BATCH}")
    if block_k < 1:
        raise ValueError(f"gemv: block_k must be >= 1, got {block_k}")
    sms = sm_count(dev.index)
    kc, ksplit = split_k(K, N, sms, block_k)
    out = torch.empty((B, N), dtype=out_dtype, device=dev)
    partial = torch.empty((ksplit if ksplit > 1 else 0, B, N),
                          dtype=torch.float32, device=dev)
    status = _entry()(x.data_ptr(), w.data_ptr(), partial.data_ptr(),
                      out.data_ptr(), B, K, N, kc, ksplit, is_bf16(x.dtype),
                      is_bf16(out_dtype),
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "gemv")
    gemv.launches += 1
    return out


gemv.launches = 0
