"""The split-K tensor-core GeMMs of the port -- ``fp8_gemm``'s e4m3 path,
``quant_gemm`` and ``int4_gemm`` (``csrc/mma.cuh``, ``csrc/wo_gemm.cuh``):
their shared planner, the exact three-term bfloat16 split of a float32 lhs
that the weight-only kernel runs, and (on the card) the kernels against
their plain versions.  The parity of the plain versions with the JAX
reference is held in ``test_torch_quant.py``, ``test_torch_lm_kernels.py``
and ``test_torch_fp8.py``.

Tolerances, each with its reason:

  * int8 x int8: EQUAL, in float32 and bfloat16 out -- the int32 sums and
    planes are exact, and the epilogue is the plain version's one cast to
    float32, one multiply and one rounding.
  * weight-only (int8 or int4 weight, float32 or bfloat16 lhs, float32
    out): rtol 1e-5 and atol 1e-5 * max|out| -- f32 sums of exact products
    in another order; a bfloat16 out 1e-2 * max|out| (one bfloat16
    rounding of a value another order can move).
  * the split: EQUAL, bit for bit.

The ``cuda``-marked tests skip here.
"""
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401
from repro_torch.kernels import _build
from repro_torch.kernels import quant_gemm as tqk
from repro_torch.quant import qtensor as tqt

WO_TOL = 1e-5           # x max|out|: f32 sums in another order
BF16_TOL = 1e-2         # x max|out|: one bfloat16 rounding
SMS = 132               # the H100's SMs

# Yi-9B's projection shapes (K, N) and its head, at both engine widths, and
# ragged ones
YI_KN = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
         (4096, 64000))
PLAN_SHAPES = [(M, K, N) for M in (1, 8, 9, 33, 128, 300)
               for K, N in YI_KN + ((97, 129), (4097, 1000))]


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


class TestSplitK:
    """``tc_split_k``, the one planner of ``fp8_gemm``'s e4m3 path,
    ``quant_gemm`` and ``int4_gemm``: one-byte weights (e4m3, int8) and
    half-byte ones (int4)."""

    @pytest.mark.parametrize("weight_bytes", [1.0, 0.5],
                             ids=["int8", "int4"])
    @pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
    def test_chunks_cover_k_once_in_whole_stages(self, M, K, N,
                                                 weight_bytes):
        bm, kc, ksplit = tqk.tc_split_k(M, K, N, SMS, weight_bytes)
        assert bm in tqk.TC_TILE_ROWS and (bm >= M or bm == 128)
        # chunk z covers K rows [z * kc, min(K, (z + 1) * kc)): every row
        # once, no chunk empty
        assert (ksplit - 1) * kc < K <= ksplit * kc
        # whole 64-deep stages, so even: an int4 chunk starts on a whole
        # packed byte
        assert kc % tqk.TC_STEP_K == 0 and kc % 2 == 0
        # the 4-byte partial planes stay within eight times the weight
        assert ksplit == 1 or ksplit * M * N * 4 <= 8 * K * N * weight_bytes

    @pytest.mark.parametrize("M", [8, 128])
    def test_grid_covers_the_card_at_n512(self, M):
        # the k / v projections: 4 column tiles, so K is split; one-byte
        # weights reach about two CTAs an SM, within a stage's rounding
        bm, _, ksplit = tqk.tc_split_k(M, 4096, 512, SMS)
        ctas = -(-M // bm) * (512 // tqk.TC_TILE_N) * ksplit
        assert 0.95 * 2 * SMS <= ctas <= 2 * SMS + 4 * ksplit

    def test_int4_planes_cap_the_split_at_one_cta_per_sm(self):
        # half a byte a weight halves the planes' room: at M = 128 the cap
        # (K / M chunks) binds before two CTAs an SM
        bm, kc, ksplit = tqk.tc_split_k(128, 4096, 512, SMS, 0.5)
        assert (bm, kc, ksplit) == (128, 128, 32)
        assert 4 * ksplit >= SMS - 4

    def test_one_chunk_where_the_tiles_fill_the_card(self):
        for wb in (1.0, 0.5):
            assert tqk.tc_split_k(128, 4096, 64000, SMS, wb)[2] == 1
            assert tqk.tc_split_k(8, 4096, 64000, SMS, wb) == (16, 4096, 1)

    def test_decode_width_splits_k(self):
        # M = 8 pads to one 16-row tile; 32 column tiles of a 4096-wide
        # output take 8 chunks of 512 rows: 256 CTAs
        assert tqk.tc_split_k(8, 4096, 4096, SMS) == (16, 512, 8)


def test_library_hash_covers_the_shared_headers():
    # int4_gemm.cu reaches mma.cuh and split_k.cuh only through wo_gemm.cuh:
    # an edit of either rebuilds it, as it rebuilds fp8_gemm and quant_gemm
    for name in ("int4_gemm", "quant_gemm", "fp8_gemm"):
        got = _build._sources(_build.CSRC / f"{name}.cu", set())
        for header in ("mma.cuh", "split_k.cuh", "cp_async.cuh",
                       "dtypes.cuh"):
            assert (_build.CSRC / header).read_bytes() in got, (name, header)
    assert (_build.CSRC / "wo_gemm.cuh").read_bytes() in _build._sources(
        _build.CSRC / "int4_gemm.cu", set())


# ---------------------------------------------------------------------------
# the exact three-term split of a float32 lhs (csrc/wo_gemm.cuh: split3)
# ---------------------------------------------------------------------------


def _cut(x: torch.Tensor) -> torch.Tensor:
    """x cut to its top 8 significant bits (the low 16 bits cleared)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def split3(a: torch.Tensor):
    """The kernel's split in plain torch: a0 the cut of a, a1 the cut of
    a - a0, a2 = a - a0 - a1 (as the kernel, its low 16 bits dropped);
    inf and NaN go whole, rounded, into a0."""
    fin = torch.isfinite(a)
    a0 = torch.where(fin, _cut(a), a.bfloat16().float())
    r1 = torch.where(fin, a - a0, torch.zeros_like(a))
    a1 = _cut(r1)
    return a0, a1, _cut(r1 - a1)


def _wide_floats(seed: int, n: int) -> torch.Tensor:
    """float32 values with random significands over the exponents the
    split covers exactly (2^-110 .. 2^127), both signs, and the limits."""
    rng = np.random.default_rng(seed)
    bits = (rng.integers(0, 2, n).astype(np.uint32) << 31) \
        | (rng.integers(17, 255, n).astype(np.uint32) << 23) \
        | rng.integers(0, 1 << 23, n).astype(np.uint32)
    edge = np.array([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,
                     0x08800000, 0x88FFFFFF, 0x3F800001, 0x3F80FFFF,
                     0x3F808080, 0x00000000, 0x80000000], np.uint32)
    return torch.from_numpy(np.concatenate([bits, edge]).view(np.float32))


class TestSplit3:
    def test_three_bfloat16_terms_sum_to_a_bit_for_bit(self):
        a = _wide_floats(0, 200_000)
        terms = split3(a)
        for t in terms:               # each term is a bfloat16 value
            assert torch.equal(t.bfloat16().float(), t)
        a0, a1, a2 = terms
        # in float32, in the order the tensor core's sums see them: bit
        # for bit, but for the sign of a zero (-0 splits into -0 and +0s)
        s = (a0 + a1) + a2
        nz = a != 0
        assert torch.equal(s[nz].view(torch.int32), a[nz].view(torch.int32))
        assert torch.equal(s, a)
        # and exactly
        exact = a0.double() + a1.double() + a2.double()
        assert torch.equal(exact, a.double())

    def test_two_terms_are_not_enough(self):
        a = _wide_floats(1, 10_000)
        a0, a1, _ = split3(a)
        assert (a0 + a1 != a).float().mean() > 0.9

    def test_the_float32_limits_do_not_overflow(self):
        # a round-to-nearest first term would be inf here; the cut is not
        a = torch.tensor([3.4028235e38, -3.4028235e38, 3.3961e38])
        a0, a1, a2 = split3(a)
        assert torch.isfinite(a0).all()
        assert torch.equal((a0 + a1) + a2, a)

    def test_inf_and_nan_propagate(self):
        a = torch.tensor([float("inf"), float("-inf"), float("nan")])
        a0, a1, a2 = split3(a)
        assert torch.equal(a0[:2], a[:2]) and torch.isnan(a0[2])
        assert torch.equal(a1, torch.zeros(3))
        assert torch.equal(a2, torch.zeros(3))
        # inf * 0 is NaN, as the reference's float32 product
        w = torch.tensor([0.0, 1.0, 2.0])
        assert torch.isnan(a0[0] * w[0]) and torch.isnan(a[0] * w[0])

    @pytest.mark.parametrize("bits", [8, 4])
    def test_each_term_times_a_weight_is_exact(self, bits):
        # every int8 and int4 weight: the three products are exact in
        # float32 (8 significant bits times at most 7), and their exact sum
        # is the product a * w
        lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
        w = torch.arange(lo, hi, dtype=torch.float32)
        a = _wide_floats(2, 4000)
        a = a[a.abs() < 2.0 ** 120]           # products stay finite
        a0, a1, a2 = (t[:, None] for t in split3(a))
        for t in (a0, a1, a2):
            assert torch.equal((t * w).double(), t.double() * w.double())
        exact = sum(t.double() * w.double() for t in (a0, a1, a2))
        assert torch.equal(exact, a.double()[:, None] * w.double())


# ---------------------------------------------------------------------------
# on the card (skip here)
# ---------------------------------------------------------------------------


def _i8(g, *shape, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


def _dirty_scratch(dev):
    """Free memory filled with NaN (as int32, a sentinel), which the next
    torch.empty hands out as the split-K scratch: every plane must be
    written before it is summed."""
    torch.empty(64 << 20, device=dev).fill_(float("nan"))


@pytest.mark.cuda
class TestOnCard:
    # Yi-9B's k / v projection (128 rows), its down projection at decode,
    # the ResNet50 and MobileNetV1 heads (N = 1000: byte loads)
    @pytest.mark.parametrize("M,K,N", [(128, 4096, 512), (8, 11008, 4096),
                                       (32, 2048, 1000), (8, 1024, 1000)])
    def test_int8_bit_for_bit(self, cuda_device, M, K, N):
        g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
        a, b = _i8(g, M, K, dev=cuda_device), _i8(g, K, N, dev=cuda_device)
        s = torch.rand(N, generator=g, device=cuda_device) * 1e-3 + 1e-5
        for out in (torch.float32, torch.bfloat16):
            _dirty_scratch(cuda_device)
            n0 = tqk.quant_gemm.launches
            got = tqk.quant_gemm(a, b, s, out_dtype=out)
            assert tqk.quant_gemm.launches == n0 + 1 and got.dtype == out
            assert torch.equal(got, tqk.quant_gemm_plain(a, b, s,
                                                         out_dtype=out))

    @pytest.mark.parametrize("M", [8, 128])
    def test_int8_sums_past_2_pow_24(self, cuda_device, M):
        # products of 127 * 127 (the first K row 127 * 125 .. 127 * 127):
        # odd sums of 1.8e8, exact only in int32, which float32 partial
        # planes would round twice; the unit scale leaves the one cast
        K, N = 11008, 512
        a = torch.full((M, K), 127, dtype=torch.int8, device=cuda_device)
        b = torch.full((K, N), 127, dtype=torch.int8, device=cuda_device)
        b[0] = 127 - torch.arange(N, device=cuda_device) % 3
        b[:, 1] *= -1
        s = torch.ones(N, device=cuda_device)
        _dirty_scratch(cuda_device)
        got = tqk.quant_gemm(a, b, s)
        want = tqk.quant_gemm_plain(a, b, s)
        assert torch.equal(got, want)
        exact = [127 * (127 * (K - 1) + 127 - n % 3) for n in range(3)]
        assert got[0, 0].item() == np.float32(exact[0])
        assert got[0, 1].item() == np.float32(-exact[1])
        assert got[0, 2].item() == np.float32(exact[2])

    @pytest.mark.parametrize("lhs", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("M,K,N", [(128, 4096, 512), (128, 11008, 4096),
                                       (33, 4097, 520)])
    def test_int4_weight_only(self, cuda_device, M, K, N, lhs):
        g = torch.Generator(device=cuda_device).manual_seed(M + K)
        q = torch.randint(-8, 8, (K, N), generator=g, device=cuda_device,
                          dtype=torch.int8)
        w = tqt.pack_int4(q, axis=0).contiguous()
        a = torch.randn(M, K, generator=g, device=cuda_device).to(lhs)
        s = torch.rand(N, generator=g, device=cuda_device) + 0.1
        for out in (torch.float32, torch.bfloat16):
            _dirty_scratch(cuda_device)
            n0 = tqk.int4_gemm.launches
            got = tqk.int4_gemm(a, w, s, k_size=K, out_dtype=out)
            assert tqk.int4_gemm.launches == n0 + 1 and got.dtype == out
            want = tqk.int4_gemm_plain(a, w, s, k_size=K, out_dtype=out)
            _close(got, want, out)

    @pytest.mark.parametrize("lhs", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("M,K,N", [(128, 4096, 512), (128, 4096, 4096),
                                       (128, 11008, 4096), (32, 2048, 1000)])
    def test_int8_weight_only(self, cuda_device, M, K, N, lhs):
        g = torch.Generator(device=cuda_device).manual_seed(M + N)
        b = _i8(g, K, N, dev=cuda_device)
        a = torch.randn(M, K, generator=g, device=cuda_device).to(lhs)
        s = torch.rand(N, generator=g, device=cuda_device) * 1e-2
        for out in (torch.float32, torch.bfloat16):
            _dirty_scratch(cuda_device)
            got = tqk.quant_gemm(a, b, s, out_dtype=out)
            assert got.dtype == out
            _close(got, tqk.quant_gemm_plain(a, b, s, out_dtype=out), out)

    def test_float32_lhs_keeps_every_bit(self, cuda_device):
        # one weight of 1 per column and a lhs whose values need all 24
        # significant bits: each output is one lhs value, times the unit
        # scale -- equal only if the three terms carry all of them
        K, N = 256, 128
        g = torch.Generator(device=cuda_device).manual_seed(7)
        a = torch.randn(16, K, generator=g, device=cuda_device) \
            * (1 + 2.0 ** -23)
        q = torch.zeros(K, N, dtype=torch.int8, device=cuda_device)
        q[torch.arange(N) * 2, torch.arange(N)] = 1
        s = torch.ones(N, device=cuda_device)
        want = a[:, ::2][:, :N]
        assert torch.equal(tqk.quant_gemm(a, q, s), want)
        w = tqt.pack_int4(q, axis=0).contiguous()
        assert torch.equal(tqk.int4_gemm(a, w, s, k_size=K), want)


def _close(got, want, out):
    tol = WO_TOL if out == torch.float32 else BF16_TOL
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    if out == torch.float32:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)
    else:
        assert float((got - want).abs().max()) <= tol * scale
