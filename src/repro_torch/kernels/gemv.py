"""Small-batch GEMV ``(B <= 8, K) @ (K, N)``: CUDA kernel and plain version.

Port of ``repro.kernels.gemv.gemv``.  The kernel (``csrc/gemv.cu``)
streams W once through a ring of shared-memory stages by 16-byte
``cp.async`` copies, float32 FMA sums on the CUDA cores, K split over a
CTA's warps and, where the column blocks are few, over CTAs in the same
launch; see the note at the top of the source.  Its grid is
:func:`gemv_plan`'s.  Operands are float32 or bfloat16 (one dtype), the
output ``out_dtype`` (default ``x.dtype``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (_build, check_operands, check_out_dtype,
                                 is_bf16, on_cpu, sm_count,
                                 split_k_workspace)
from repro_torch.kernels.ref import gemv_ref as gemv_plain  # noqa: F401

MAX_BATCH = 8
# the kernel's constants (csrc/gemv.cu: kCols, kThreads, kStageBytes,
# kStages, the ring's bytes, kCtasPerSm), checked against the library's
# gemv_tiles when it loads
GEMV_COLS = 128           # columns a CTA, 4 a lane
GEMV_THREADS = 256        # 8 warps, K split over them
GEMV_STAGE_BYTES = 16384  # weight bytes a stage: 32 float32 / 64 bf16 rows
GEMV_STAGES = 4
# a slot: the stage's weight and its k rows of 8 rows of x (1 KB)
GEMV_RING_BYTES = GEMV_STAGES * (GEMV_STAGE_BYTES + MAX_BATCH * 128)
GEMV_CTAS_PER_SM = 2
# a split's chunks are multiples of 8 rows, so that x's 16-byte copies
# stay aligned in both types
GEMV_CHUNK_ROWS = 8
GEMV_MAX_SPLIT = 256
# the planner's model of a K split, in bytes of a CTA's weight (fitted to
# the splits' device times at Yi-9B's decode shapes and the ResNet50 and
# MobileNetV1 heads, float32 and bfloat16, on an H100 in
# tools/split_sweep.py --gemv): the CTAs on an SM share its bytes a second,
# so the busiest SM's L CTAs take L CTAs' time; a CTA walks whole stages,
# and costs GEMV_CTA_COST bytes beyond them (its first stages' latency,
# its warps' sum), and each K chunk of a split column block
# GEMV_PLANE_COST (its plane, the fence and counter, the last CTA's read)
GEMV_CTA_COST = 24576
GEMV_PLANE_COST = 8192


def gemv_vec(N: int, elem_bytes: int, address: int) -> int:
    """The weight's copy width in bytes: the widest of 16, 8, 4 and 2 that
    divides both a row's bytes (so every row starts on it) and the weight's
    address, and holds whole elements."""
    return next(v for v in (16, 8, 4, 2)
                if v >= elem_bytes and N * elem_bytes % v == 0
                and address % v == 0)


def gemv_cost(K: int, N: int, sms: int, kc: int, elem_bytes: int) -> float:
    """:func:`gemv_plan`'s model of a split into chunks of ``kc`` rows, in
    bytes of one CTA's weight stages."""
    ks = -(-K // kc)
    busiest = -(-(-(-N // GEMV_COLS)) * ks // sms)
    stages = -(-kc * GEMV_COLS * elem_bytes // GEMV_STAGE_BYTES)
    return busiest * (stages * GEMV_STAGE_BYTES + GEMV_CTA_COST) \
        + GEMV_PLANE_COST * ks


@functools.lru_cache(maxsize=4096)
def gemv_plan(K: int, N: int, sms: int, elem_bytes: int) -> tuple[int, int]:
    """``(kc, ksplit)``: K splits into ``ksplit`` chunks of ``kc`` rows over
    a grid of ``ceil(N / 128) x ksplit`` CTAs (any B <= 8: the kernel keeps
    8 rows' sums).

    The split of at most GEMV_MAX_SPLIT chunks (multiples of
    GEMV_CHUNK_ROWS rows) with the least modeled time (:func:`gemv_cost`):
    the L = ceil(CTAs / ``sms``) CTAs of the busiest SM take L x (the bytes
    of a CTA's whole weight stages + GEMV_CTA_COST), and every chunk
    GEMV_PLANE_COST more.
    So the grid runs in whole waves where that pays, and a few column
    blocks (k / v, the vision heads) split K only part of the way to
    filling the card: past that the split-K hand-off costs more than the
    idle SMs.  A CTA's shared memory does not grow with ``kc``: x streams
    through the ring with the weight."""
    best = None
    for want in range(1, min(K, GEMV_MAX_SPLIT) + 1):
        kc = -(-K // want)
        if want > 1:
            kc = -(-kc // GEMV_CHUNK_ROWS) * GEMV_CHUNK_ROWS
        ks = -(-K // kc)
        if ks != want:                  # the same split as a smaller want
            continue
        cost = gemv_cost(K, N, sms, kc, elem_bytes)
        if best is None or cost < best[0]:
            best = (cost, kc, ks)
    return best[1], best[2]


def _entry():
    fn = _build.load("gemv").gemv
    fn.argtypes = [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _launcher():
    """Once a process: the bound C entry, the library's constants checked
    against the planner's."""
    _build.check_constants(_build.load("gemv"), "gemv_tiles",
                           (GEMV_COLS, GEMV_THREADS, GEMV_STAGE_BYTES,
                            GEMV_STAGES, GEMV_RING_BYTES, GEMV_CTAS_PER_SM))
    return _entry()


def gemv(x: torch.Tensor, w: torch.Tensor, *, block_k: int = 512,
         out_dtype=None) -> torch.Tensor:
    """``x (B, K) | (K,) @ w (K, N)`` with B <= 8, float32 accumulation.

    The grid and its K split are :func:`gemv_plan`'s, from the shape and
    the SM count; the function does not depend on the blocking, so
    ``block_k`` (the reference's K block, kept in the signature) is
    checked and not used."""
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
    """One launch on CUDA operands; raise on what the kernel does not
    take, before the library is built."""
    dev = check_operands("gemv", x, w)
    out_dtype = check_out_dtype("gemv", out_dtype, x.dtype)
    B, K = x.shape
    N = w.shape[1]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"gemv: batch {B} outside 1..{MAX_BATCH}")
    if block_k < 1:
        raise ValueError(f"gemv: block_k must be >= 1, got {block_k}")
    eb = x.element_size()
    kc, ksplit = gemv_plan(K, N, sm_count(dev.index), eb)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, N), dtype=out_dtype, device=dev)
    planes = counters = None
    if ksplit > 1:
        planes, counters = split_k_workspace(dev, stream, ksplit * B * N,
                                             -(-N // GEMV_COLS))
    status = _launcher()(
        x.data_ptr(), w.data_ptr(),
        None if planes is None else planes.data_ptr(),
        None if counters is None else counters.data_ptr(), out.data_ptr(),
        _build.int_args(B, K, N, kc, ksplit, gemv_vec(N, eb, w.data_ptr()),
                        is_bf16(x.dtype), is_bf16(out_dtype)),
        stream)
    _build.check(status, "gemv")
    gemv.launches += 1
    return out


gemv.launches = 0
