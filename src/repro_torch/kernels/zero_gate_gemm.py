"""Block-sparse zero-gated GeMM: the CUDA kernel, its plain version and the
block-occupancy mask.

Port of ``repro.kernels.zero_gate_gemm``.  The paper gates single MACs to
save power; the reference turns that into a time saving at block
granularity, and so does this port: :func:`block_mask` marks which
``(bm, bk)`` blocks of A hold a nonzero, and the kernel
(``csrc/zero_gate_gemm.cu``) skips every block's products where the mask
is 0: a pipelined split-K tile at M > 8, a streaming form at M <= 8, both
with K chunks inside the mask's K blocks (:func:`zg_split_k`).  Operands
are float32 or bfloat16 (one dtype), the output ``out_dtype`` (default
``a.dtype``).  The mask is plain PyTorch (no hand kernel is owed for it);
ragged edge blocks count as the reference counts them, on A zero-padded
to whole blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import (_build, check_operands, check_out_dtype,
                                 float_dtype, is_bf16, on_cpu, sm_count)

# the kernel's constants (csrc: kBN, kStep, kTileCtasPerSm, kStreamThreads,
# kMaxRows), checked against the source when it loads
TILE_N = 128           # tile form: output columns per CTA
TILE_STEP = 32         # tile form: K depth of one pipeline stage
TILE_CTAS_PER_SM = 2   # the tile's occupancy
STREAM_THREADS = 128   # stream form: threads (16 bytes of b each) per CTA
STREAM_ROWS = 8        # M at or below which the streaming form runs
# the planner's own choices
TILE_ROWS = (32, 64, 128)
STREAM_STEP = 16       # stream form: the K split's step
STREAM_CTAS_PER_SM = 4


def block_mask(a: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """``(ceil(M / bm), ceil(K / bk))`` int32 occupancy mask of A's blocks:
    1 where the zero-padded block holds a nonzero."""
    M, K = a.shape
    a_p = F.pad(a, (0, (-K) % bk, 0, (-M) % bm))
    Mp, Kp = a_p.shape
    blocks = a_p.reshape(Mp // bm, bm, Kp // bk, bk)
    return (blocks != 0).any(dim=3).any(dim=1).to(torch.int32)


def skip_fraction(mask: torch.Tensor) -> float:
    """Fraction of block products gated off (the time analogue of the
    paper's power saving)."""
    return float(1.0 - mask.float().mean())


def zero_gate_gemm_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int,
                         bk: int, mask: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """The same function in plain PyTorch, the kernel's float32 oracle:
    for each K block in order, the float32 product of every live
    ``(bm, bk)`` block of A added into the accumulator.  The kernel sums in
    its own order (split-K chunks inside each K block, summed after), so
    the two agree to float32 rounding, not bit for bit."""
    M, K = a.shape
    out_dtype = out_dtype or a.dtype
    af, bf = a.float(), b.float()
    live = mask.bool().repeat_interleave(bm, dim=0)[:M]      # (M, nkb)
    acc = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for l, k0 in enumerate(range(0, K, bk)):
        rows = live[:, l]
        if not bool(rows.any()):
            continue
        part = torch.where(rows[:, None], af[:, k0:k0 + bk], 0.0)
        acc = acc + torch.matmul(part, bf[k0:k0 + bk])
    return acc.to(out_dtype)


def zg_split_k(M: int, K: int, N: int, bk: int, itemsize: int, sms: int
               ) -> tuple[int, int, int, int, int]:
    """``(tile_m, kc, sub, bpc, chunks)``: the kernel's tile and K split for
    a mask of K blocks of ``bk`` rows.

    ``tile_m``: the tile form's rows per CTA (M > 8), the smallest of 32,
    64, 128 that covers M (128 above): the kernel skips a dead mask row
    block's products warp by warp, so the tile need not follow the mask's
    ``bm``; the streaming form (M <= 8) returns M.
    K splits into ``chunks`` chunks whose edges are the mask's K-block
    edges or lie inside one block: each a run of ``bpc`` whole blocks
    (``sub`` = 1, ``kc`` = ``bk``), or one of ``sub`` pieces of ``kc`` rows
    of a block (``bpc`` = 1; the last pieces of a ragged last block may be
    empty).  The tile form takes as many chunks as fit one wave of two
    CTAs on each of ``sms`` SMs (a second, partial wave would idle most of
    the card); the streaming form about four CTAs per SM.  No more chunks
    than keep the f32 partial planes within eight times the bytes of b;
    ``kc`` a multiple of the form's K step unless it is the whole
    block."""
    bk = min(bk, K)
    nkb = -(-K // bk)
    if M <= STREAM_ROWS:
        tile_m, step = M, STREAM_STEP
        tiles = -(-N // (STREAM_THREADS * (16 // itemsize)))
        want = -(-STREAM_CTAS_PER_SM * sms // tiles)
    else:
        tile_m = next((t for t in TILE_ROWS if t >= M), TILE_ROWS[-1])
        step = TILE_STEP
        tiles = -(-M // tile_m) * -(-N // TILE_N)
        want = TILE_CTAS_PER_SM * sms // tiles       # one wave at most
    want = max(1, min(want, 2 * K * itemsize // M))
    if want <= nkb:
        bpc = -(-nkb // want)
        return tile_m, bk, 1, bpc, -(-nkb // bpc)
    sub = -(-want // nkb)
    kc = -(-bk // sub)
    kc = min(-(-kc // step) * step, bk)        # up to a whole step
    sub = -(-bk // kc)
    return tile_m, kc, sub, 1, nkb * sub


@functools.lru_cache(maxsize=None)
def _check_constants() -> None:
    """Once a process: the source's constants are the planner's."""
    _build.check_constants(_build.load("zero_gate_gemm"),
                           "zero_gate_gemm_tiles",
                           (TILE_N, TILE_STEP, TILE_CTAS_PER_SM,
                            STREAM_THREADS, STREAM_ROWS))


def _entry():
    fn = _build.load("zero_gate_gemm").zero_gate_gemm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def zero_gate_gemm(a: torch.Tensor, b: torch.Tensor, *,
                   block: tuple[int, int, int] = (128, 128, 128),
                   mask: torch.Tensor | None = None,
                   out_dtype=None) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` with the products of A's gated-off blocks
    skipped.  ``block = (bm, bk, bn)``, clamped to the dims: ``(bm, bk)``
    is the mask's block (``mask`` None: :func:`block_mask` of ``a``); the
    kernel's own tile and K split are :func:`zg_split_k`'s, so ``bn`` is
    not used."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"zero_gate_gemm: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if min(block) < 1:
        raise ValueError(f"zero_gate_gemm: block {block} must be >= 1")
    bm, bk = min(block[0], M), min(block[1], K)
    if mask is None:
        mask = block_mask(a, bm, bk)
    want = (-(-M // bm), -(-K // bk))
    if tuple(mask.shape) != want:
        raise ValueError(f"zero_gate_gemm: mask {tuple(mask.shape)}, "
                         f"expected {want}")
    if on_cpu(a, b, mask):
        return zero_gate_gemm_plain(a, b, bm=bm, bk=bk, mask=mask,
                                    out_dtype=out_dtype)
    dt = float_dtype("zero_gate_gemm", a, b)
    dev = check_operands("zero_gate_gemm", a, b, mask,
                         dtypes=(dt, dt, torch.int32))
    out_dtype = check_out_dtype("zero_gate_gemm", out_dtype, a.dtype)
    _check_constants()
    sms = sm_count(dev.index)
    tile_m, kc, sub, bpc, chunks = zg_split_k(M, K, N, bk, a.element_size(),
                                              sms)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    partial = torch.empty((chunks if chunks > 1 else 0, M, N),
                          dtype=torch.float32, device=dev)
    status = _entry()(
        mask.data_ptr(), a.data_ptr(), b.data_ptr(), partial.data_ptr(),
        out.data_ptr(), M, K, N, bm, bk, tile_m, kc, sub, bpc, chunks,
        is_bf16(dt), is_bf16(out_dtype),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "zero_gate_gemm")
    zero_gate_gemm.launches += 1
    return out


zero_gate_gemm.launches = 0
