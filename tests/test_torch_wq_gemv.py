"""The port's streaming GEMVs, ``kernels.quant_gemm.wq_gemv`` (int8
weight) and ``int4_gemv`` (nibble-packed int4 weight), one tensor-core
design (``csrc/wq_gemv.cuh``): its planner (``wq_plan``, ``wq_vec``), numpy
models of what the kernel computes, and the int8 kernel against its plain
version on the card.

The models run on the CPU what the kernel does on the card: each int8
byte decoded to an exact bfloat16 (the byte in the mantissa of 2^23, less
2^23 + 128, then the float's high half); each packed int4 byte's two
nibbles decoded to one bf16x2 register (each nibble xor 8 in the low
mantissa bits of bfloat16 128.0, less 136), EQUAL to ``unpack_int4`` for
all 256 bytes; the lane-to-fragment mapping of both formats (which bytes a
lane reads, and which mma A-fragment values they become), EQUAL to the
weight; each float32 value of x split into three bfloat16 terms whose sum
it is (``f32_terms.cuh``, split3); and the K walk -- each CTA's K chunk in
stages of 64 rows, one 16-row step for each of 4 warps along K, their
sums and the split-K planes in a fixed order -- held against the plain
version: within 1e-5 * max|out| (float32 sums in another order), and
EQUAL on integer-valued operands whose sums stay below 2^24, where every
order is exact and a row read twice or skipped shows.  The reference's own
parity tests are in ``tests/test_torch_quant.py`` and
``tests/test_torch_lm_kernels.py``.  The tests marked ``cuda`` run the
int8 kernel on the card (the int4 one's are in
``tests/test_torch_lm_kernels.py``).
"""
import re

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401
from repro_torch import kernels as tk
from repro_torch.core import hw
from repro_torch.kernels import _build
from repro_torch.kernels import quant_gemm as tqk
from repro_torch.quant.qtensor import pack_int4, unpack_int4

SMS = 132                      # an H100 SXM's SMs
RTOL = 1e-5                    # x max|out|: float32 sums in another order
STAGES = 4                     # csrc/wq_gemv.cuh Int8::kStages
INT4_STAGES = 4                # Int4::kStages
WARPS_N = 2                    # kWarpsN: warps side by side along N
WARPS_K = tqk.WQ_THREADS // 32 // WARPS_N   # warps splitting K
STEP = tqk.WQ_STAGE_ROWS // WARPS_K   # a warp's k rows a stage: one k16

# Yi-9B's decode projections and head (K, N), and the ResNet50 head
DECODE_SHAPES = [(4096, 512), (4096, 4096), (4096, 11008), (11008, 4096),
                 (4096, 64000), (2048, 1000)]
# K chunks: the split tools/split_sweep.py --wq measured fastest at each,
# or within 3 % of it, on an H100 80GB HBM3 at 700 W (k / v: 11, between
# the sweep's 8 and 12, both within 3 % of its best)
SWEEP_PICKS = {(4096, 512): 11, (4096, 4096): 4, (4096, 11008): 3,
               (11008, 4096): 8, (4096, 64000): 1, (2048, 1000): 8}


def _rows_of_chunk(length: int, stage_rows: int = tqk.WQ_STAGE_ROWS
                   ) -> np.ndarray:
    """Row r of a CTA's chunk -> how many (stage, K warp, step, k) of the
    kernel read it: K warp w reads rows s * stage_rows + h * 64 + w * 16 +
    k, k < 16, of stage s in its step h (one step a stage for int8, two for
    int4); rows past the chunk are zeros in x, so they add nothing."""
    stages = -(-length // stage_rows)
    s, h, w, k = np.meshgrid(np.arange(stages),
                             np.arange(stage_rows // tqk.WQ_STAGE_ROWS),
                             np.arange(WARPS_K), np.arange(STEP),
                             indexing="ij")
    r = (s * stage_rows + h * tqk.WQ_STAGE_ROWS + w * STEP + k).ravel()
    return np.bincount(r[r < length], minlength=length)


def _decode_bytes(q: np.ndarray) -> np.ndarray:
    """int8 bytes as the kernel decodes them: 2^23 + (v + 128) as a float
    (the byte xor 0x80 in the mantissa), less 2^23 + 128; the bfloat16 is
    the float's high half, so the low half must be zero."""
    bits = (q.view(np.uint8).astype(np.uint32) ^ 0x80) | 0x4B000000
    f = bits.view(np.float32) - np.float32(8388736.0)
    assert not (f.view(np.uint32) & 0xFFFF).any()
    return f


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    """The bfloat16 values of 16-bit patterns, as float32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _decode_packed(u: np.ndarray, p: int) -> tuple:
    """Byte p of uint32 words u as the int4 kernel decodes it (Int4::pair):
    PRMT of u and u >> 4 puts the byte in the low half and the byte shifted
    down by 4 in the high half; LOP3 keeps each half's low nibble, xor 8,
    under bfloat16 128.0's high byte (0x43); one bf16x2 FMA subtracts 136.
    Returns the (low nibble, high nibble) values, float32."""
    u = np.asarray(u, np.uint32)
    sh = u >> np.uint32(4)
    perm = ((u >> np.uint32(8 * p)) & np.uint32(0xFF)) \
        | (((sh >> np.uint32(8 * p)) & np.uint32(0xFF)) << np.uint32(16))
    b = (perm & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    lo = _bf16_value(b & np.uint32(0xFFFF)) - np.float32(136.0)
    hi = _bf16_value(b >> np.uint32(16)) - np.float32(136.0)
    for half in (b & np.uint32(0xFFFF), b >> np.uint32(16)):
        # 128 + (n ^ 8): exactly representable, so the FMA is exact
        assert np.array_equal(_bf16_value(half) - 128, half & 0xF)
    return lo, hi


def _lane_fragments(stage: np.ndarray, fmt: str, kk: int, col: int,
                    t: int) -> np.ndarray:
    """The A registers F::frags builds for lane (g, t) of a warp whose k16
    step starts at stage row kk, its columns col .. col + 7 (wn * 64 + g *
    8): [tile j][register r] -> the (lower k, upper k) value pair.  stage:
    the stage's byte rows (64 int8 or 32 packed) x 128 columns, int8."""
    words = np.ascontiguousarray(stage).view(np.uint32)   # 32 words a row
    out = np.zeros((tqk.WQ_COLS // 2 // 16, 4, 2), np.float32)
    for j in range(out.shape[0]):
        wd, p = j // 2, 2 * (j % 2)   # the lane's word, byte of column 2j
        for r in range(4):
            pp = p + r % 2            # r odd: tile row g + 8, column 2j + 1
            if fmt == "int8":         # rows kk + 2t, + 1 (r < 2), + 8, + 9
                k = kk + 2 * t + 8 * (r // 2)
                out[j, r] = _decode_bytes(stage[[k, k + 1], col + 4 * wd
                                                + pp])
            else:                     # packed rows kk / 2 + t (+ 4)
                u = words[kk // 2 + t + 4 * (r // 2), col // 4 + wd]
                lo, hi = _decode_packed(np.array([u]), pp)
                out[j, r] = lo[0], hi[0]
    return out


def _split3(x: np.ndarray) -> list:
    """Three bfloat16 terms of float32 x, as float32 with zero low halves:
    x cut to its top 8 significant bits, the rest cut the same, and what is
    left (f32_terms.cuh, split3)."""
    x = np.asarray(x, np.float32)
    t0 = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)
    r1 = (x - t0).astype(np.float32)
    t1 = (r1.view(np.uint32) & 0xFFFF0000).view(np.float32)
    t2 = (r1 - t1).astype(np.float32)
    return [t0, t1, t2]


def _wq_by_ctas(x, w, scale, plan, stage_rows=tqk.WQ_STAGE_ROWS):
    """``wq_gemv`` (``int4_gemv`` with ``stage_rows`` 128) as the
    tensor-core kernel computes it: per CTA (column block, K chunk) each K
    warp's k16 steps accumulated in float32 in stage and step order (each
    step's 16 products of x's three terms, exact, summed in float64: the
    mma's own order is its own), the 4 K warps summed in order; then the
    planes in order and the column scale."""
    x, w = np.asarray(x, np.float32), np.asarray(w, np.int8)
    B, K = x.shape
    N = w.shape[1]
    kc, ks = plan
    wf = _decode_bytes(w).astype(np.float64)
    xt = sum(t.astype(np.float64) for t in _split3(x))
    planes = np.zeros((ks, B, N), np.float32)
    for cy in range(ks):
        k0 = cy * kc
        length = min(K, k0 + kc) - k0
        acc = np.zeros((WARPS_K, B, N), np.float32)
        for s in range(-(-length // stage_rows)):
            for h in range(stage_rows // tqk.WQ_STAGE_ROWS):
                for wi in range(WARPS_K):
                    r0 = k0 + s * stage_rows + h * tqk.WQ_STAGE_ROWS \
                        + wi * STEP
                    rows = slice(r0, min(k0 + length, r0 + STEP))
                    acc[wi] = acc[wi] + (xt[:, rows] @ wf[rows]).astype(
                        np.float32)
        tot = acc[0]
        for wi in range(1, WARPS_K):
            tot = tot + acc[wi]
        planes[cy] = tot
    out = planes[0]
    for p in range(1, ks):
        out = out + planes[p]
    return out * np.asarray(scale, np.float32)


class TestDecode:
    def test_every_byte_decodes_exactly(self):
        q = np.arange(-128, 128, dtype=np.int8)
        assert np.array_equal(_decode_bytes(q).astype(np.int32), q)

    # split3 is exact for |x| >= 2^-110 (f32_terms.cuh)
    @pytest.mark.parametrize("magnitude", [1e-20, 1e-6, 1.0, 3e4, 1e30])
    def test_three_bf16_terms_rebuild_every_value(self, magnitude):
        rng = np.random.default_rng(int(np.log10(magnitude)) + 40)
        x = (rng.standard_normal((8, 4096)) * magnitude).astype(np.float32)
        terms = _split3(x)
        for t in terms:                    # each term a bfloat16
            assert not (t.view(np.uint32) & 0xFFFF).any()
        rebuilt = sum(t.astype(np.float64) for t in terms)
        assert np.array_equal(rebuilt, x.astype(np.float64))

    def test_every_packed_byte_decodes_exactly(self):
        # all 256 bytes at each byte position of a word, the word's other
        # bytes arbitrary (u >> 4 carries bits across bytes)
        b = np.arange(256, dtype=np.uint32)
        packed = torch.from_numpy(b.astype(np.uint8).view(np.int8).copy())
        want = unpack_int4(packed[:, None], 512, axis=0)[:, 0].numpy()
        rng = np.random.default_rng(5)
        for p in range(4):
            other = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(
                np.uint32) & np.uint32(~(0xFF << 8 * p) & 0xFFFFFFFF)
            lo, hi = _decode_packed(other | (b << np.uint32(8 * p)), p)
            assert np.array_equal(lo, want[0::2].astype(np.float32))
            assert np.array_equal(hi, want[1::2].astype(np.float32))

    @pytest.mark.parametrize("fmt", ["int8", "int4"])
    def test_lane_fragments_are_the_weight(self, fmt):
        # every warp's lanes read exactly the A fragments of w^T: tile j's
        # row g (registers 0, 2) is the lane's column 2j, row g + 8
        # (registers 1, 3) column 2j + 1; registers 0, 1 hold k rows 2t,
        # 2t + 1 of the warp's k16 step, 2, 3 rows 2t + 8, 2t + 9; each
        # (k, column) of the stage once
        # (an int4 stage is two k16 steps a warp, 128 k rows)
        rng = np.random.default_rng(11)
        lim, rows = (128, tqk.WQ_STAGE_ROWS) if fmt == "int8" else \
            (8, tqk.INT4_STAGE_ROWS)
        w = rng.integers(-lim, lim, (rows, tqk.WQ_COLS)).astype(np.int8)
        stage = w if fmt == "int8" else \
            pack_int4(torch.from_numpy(w), axis=0).numpy()
        seen = np.zeros(w.shape, int)
        for kk in range(0, rows, 16):           # step h of K warp wk
            for wn in range(WARPS_N):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    col = wn * tqk.WQ_COLS // WARPS_N + 8 * g
                    fr = _lane_fragments(stage, fmt, kk, col, t)
                    for j in range(fr.shape[0]):
                        for r in range(4):
                            c = col + 2 * j + r % 2
                            k = kk + 2 * t + 8 * (r // 2)
                            assert (fr[j, r] == w[k:k + 2, c]).all()
                            seen[k:k + 2, c] += 1
        assert (seen == 1).all()

    def test_integer_values_split_exactly(self):
        x = np.arange(-300, 301, dtype=np.float32)
        assert np.array_equal(sum(t.astype(np.float64) for t in _split3(x)),
                              x.astype(np.float64))


class TestPlan:
    @pytest.mark.parametrize("K,N", DECODE_SHAPES + [
        (1, 7), (37, 1000), (100, 70), (513, 1023), (100_000, 256),
        (300, 4100), (64, 128), (65, 129)])
    def test_chunks_cover_k_once(self, K, N):
        kc, ks = tqk.wq_plan(K, N, SMS)
        assert kc * (ks - 1) < K <= kc * ks
        chunks = np.concatenate([k0 + np.flatnonzero(_rows_of_chunk(
            min(K, k0 + kc) - k0)) for k0 in range(0, K, kc)])
        assert np.array_equal(chunks, np.arange(K))
        for k0 in range(0, K, kc):
            assert (_rows_of_chunk(min(K, k0 + kc) - k0) == 1).all()

    @pytest.mark.parametrize("K,N", DECODE_SHAPES)
    def test_picks_the_sweeps_split(self, K, N):
        # tools/split_sweep.py --wq on an H100 80GB HBM3: the split each
        # shape ran fastest in, or one within 3 % of it
        assert tqk.wq_plan(K, N, SMS)[1] == SWEEP_PICKS[(K, N)]

    def test_wide_heads_split_k_little(self):
        # 500 column blocks already fill the card several times over
        kc, ks = tqk.wq_plan(4096, 64000, SMS)
        assert ks <= 2

    def test_narrow_projections_split_k_part_way(self):
        # k / v: 4 column blocks; K splits, but not until every SM has a
        # CTA -- past a point the split-K hand-off costs more than an idle
        # SM
        kc, ks = tqk.wq_plan(4096, 512, SMS)
        assert 1 < ks and 4 * ks < SMS and kc >= 16

    def test_shared_memory_does_not_grow_with_k(self):
        # x streams through the ring with the weight: one CTA may walk all
        # of a long K
        assert tqk.WQ_RING_BYTES + 16 <= hw.SMEM_STATIC_LIMIT
        kc, ks = tqk.wq_plan(100_000, 64000, SMS)
        assert kc * ks >= 100_000

    @pytest.mark.parametrize("N,address,want", [
        (4096, 0, 16), (64000, 256, 16), (1000, 0, 8), (1000, 4, 4),
        (1023, 0, 1), (4096, 3, 1), (4096, 8, 8), (517, 16, 1),
        (4100, 0, 4)])
    def test_copy_width_falls_back(self, N, address, want):
        assert tqk.wq_vec(N, address) == want

    def test_workspace_grows_and_keeps_counters_zero(self):
        # the streaming GEMVs' per-stream workspace (kernels/__init__.py,
        # shared with gemv)
        dev = torch.device("cpu")
        tk._split_k_scratch.pop((dev.index, 1), None)
        planes, counters = tk.split_k_workspace(dev, 1, 100, 4)
        assert planes.numel() >= 100 and counters.numel() >= 4
        assert not counters.any() and counters.dtype == torch.int32
        again = tk.split_k_workspace(dev, 1, 50, 2)
        assert again[0] is planes and again[1] is counters
        bigger = tk.split_k_workspace(dev, 1, 400, 3)
        assert bigger[0].numel() >= 400 and bigger[1].numel() >= 4
        assert not bigger[1].any()
        tk._split_k_scratch.pop((dev.index, 1))

    def test_constants_match_the_source(self):
        # the design lives in wq_gemv.cuh, which both GEMVs include
        src = b"\n".join(_build._sources(_build.CSRC / "wq_gemv.cu",
                                          set())).decode()

        def const(name, where=""):
            return int(re.search(rf"{where}constexpr int {name} = (\d+);",
                                 src, re.S).group(1))
        assert const("kCols") == tqk.WQ_COLS
        assert const("kThreads") == tqk.WQ_THREADS
        assert const("kWarpsN") == WARPS_N
        int8, int4 = r"struct Int8 \{.*?", r"struct Int4 \{.*?"
        assert const("kStages", int8) == STAGES
        assert const("kStages", int4) == INT4_STAGES
        assert const("kRowsPerByte", int4) == 2
        assert const("kMaxB") == tqk.MAX_BATCH
        assert "kStepRows = 16 * kWarpsK;" in src
        assert "kStageRows = kStepRows * F::kSteps;" in src
        assert tqk.WQ_STAGE_ROWS == 16 * WARPS_K * const("kSteps", int8)
        assert tqk.INT4_STAGE_ROWS == 16 * WARPS_K * const("kSteps", int4)
        # a stage: its weight byte rows and 8 rows of x of its k rows (+ 8)
        assert "kXLd = kStageRows + 8;" in src
        for ring, stages, rows, per_byte in (
                (tqk.WQ_RING_BYTES, STAGES, tqk.WQ_STAGE_ROWS, 1),
                (tqk.INT4_RING_BYTES, INT4_STAGES, tqk.INT4_STAGE_ROWS, 2)):
            assert ring == stages * (rows // per_byte * tqk.WQ_COLS
                                     + 8 * (rows + 8) * 4)
        for name, fmt in (("wq_gemv", "Int8"), ("int4_gemv", "Int4")):
            cu = (_build.CSRC / f"{name}.cu").read_text()
            assert f"wq::run<wq::{fmt}>" in cu
            tiles = cu.split(f'extern "C" void {name}_tiles(')[1]
            assert f"kRingBytes = wq::Ring<wq::{fmt}>::kBytes;" in tiles
            for c in ("kCols", "kStageRows", "kThreads", "kRingBytes"):
                assert f"= {c};" in tiles

    def test_args_the_source_reads(self):
        src = (_build.CSRC / "wq_gemv.cu").read_text().split(
            'extern "C" int wq_gemv(')[1]
        reads = re.findall(r"= args\[(\d+)\]", src)
        assert [int(i) for i in reads] == list(range(8))

    def test_int4_args_the_source_reads(self):
        # the wrapper passes both GEMVs one argument array, in one order
        src = (_build.CSRC / "int4_gemv.cu").read_text().split(
            'extern "C" int int4_gemv(')[1]
        reads = re.findall(r"(\w+) = args\[(\d+)\]", src)
        assert [int(i) for _, i in reads] == list(range(8))
        wq = (_build.CSRC / "wq_gemv.cu").read_text().split(
            'extern "C" int wq_gemv(')[1]
        assert reads == re.findall(r"(\w+) = args\[(\d+)\]", wq)


class TestInt4Plan:
    """``wq_plan(weight_bytes=0.5)``, the packed GEMV's split, at the shapes
    of the CUDA-core kernel's split tests it replaces."""

    @pytest.mark.parametrize("K,N,want", [
        (4096, 4096, 4), (11008, 512, 11), (33, 70, 1), (4097, 64000, 1),
        (15, 300, 1), (4096, 512, 8), (4096, 11008, 3), (11008, 4096, 8),
        (4096, 64000, 1)])
    def test_chunks_start_on_whole_bytes(self, K, N, want):
        kc, ks = tqk.wq_plan(K, N, SMS, weight_bytes=0.5)
        assert kc * (ks - 1) < K <= kc * ks               # K once
        # a split's chunks are whole 128-row stages: each starts on a whole
        # packed byte (an even k)
        rows = tqk.INT4_STAGE_ROWS
        assert ks == 1 or kc % rows == 0
        assert ks == want
        # the model's least cost over every split into whole stages
        cands = [K] + [rows * m for m in range(1, -(-K // rows))
                       if -(-K // (rows * m)) <= tqk.WQ_MAX_SPLIT]
        assert tqk.wq_cost(K, N, SMS, kc, 0.5) == min(
            tqk.wq_cost(K, N, SMS, c, 0.5) for c in cands)

    @pytest.mark.parametrize("K,N", DECODE_SHAPES + [(97, 129), (4097, 1000)])
    def test_chunks_cover_k_once(self, K, N):
        kc, ks = tqk.wq_plan(K, N, SMS, weight_bytes=0.5)
        for k0 in range(0, K, kc):
            assert k0 % 2 == 0
            assert (_rows_of_chunk(min(K, k0 + kc) - k0,
                                   tqk.INT4_STAGE_ROWS) == 1).all()

    def test_half_the_bytes_split_no_more(self):
        # a CTA's rows cost half as much, its fixed cost the same
        for K, N in DECODE_SHAPES:
            assert tqk.wq_plan(K, N, SMS, weight_bytes=0.5)[1] <= \
                tqk.wq_plan(K, N, SMS)[1]


class TestKWalkModel:
    """The kernel's K walk in numpy, held against the plain version."""

    @pytest.mark.parametrize("B,K,N", [(8, 4096, 512), (8, 2048, 1000),
                                       (3, 1000, 300), (1, 37, 1000),
                                       (5, 513, 1023), (8, 300, 129)])
    def test_model_matches_plain(self, B, K, N):
        rng = np.random.default_rng(K + N)
        x = rng.standard_normal((B, K)).astype(np.float32)
        w = rng.integers(-127, 128, (K, N)).astype(np.int8)
        scale = rng.random(N).astype(np.float32) * 1e-2 + 1e-3
        got = _wq_by_ctas(x, w, scale, tqk.wq_plan(K, N, SMS))
        want = tqk.wq_gemv_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(scale)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * float(np.abs(want).max()))

    @pytest.mark.parametrize("B,K,N", [(8, 4096, 512), (1, 97, 129),
                                       (5, 11008, 300), (8, 2048, 1000)])
    def test_int4_model_matches_plain(self, B, K, N):
        # the packed kernel walks K in 128-row stages (64 packed rows, two
        # k16 steps a warp), its chunks from wq_plan(weight_bytes=0.5)
        rng = np.random.default_rng(K + N + 1)
        x = rng.standard_normal((B, K)).astype(np.float32)
        w = rng.integers(-8, 8, (K, N)).astype(np.int8)
        scale = rng.random(N).astype(np.float32) * 1e-2 + 1e-3
        got = _wq_by_ctas(x, w, scale,
                          tqk.wq_plan(K, N, SMS, weight_bytes=0.5),
                          tqk.INT4_STAGE_ROWS)
        want = tqk.int4_gemv_plain(
            torch.from_numpy(x), pack_int4(torch.from_numpy(w), axis=0),
            torch.from_numpy(scale), k_size=K).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * float(np.abs(want).max()))

    @pytest.mark.parametrize("B,K,N", [(8, 11008, 256), (2, 4096, 512),
                                       (7, 777, 1000)])
    def test_integer_operands_are_exact(self, B, K, N):
        # |x|, |w| <= 8: |sum| <= 64 K < 2^24, exact in any order
        rng = np.random.default_rng(B * K)
        x = rng.integers(-8, 9, (B, K)).astype(np.float32)
        w = rng.integers(-8, 9, (K, N)).astype(np.int8)
        got = _wq_by_ctas(x, w, np.ones(N, np.float32), tqk.wq_plan(K, N, SMS))
        want = (x.astype(np.float64) @ w.astype(np.float64)).astype(
            np.float32)
        assert np.array_equal(got, want)


@pytest.mark.cuda
class TestOnCard:
    """The kernel against its plain version on the card."""

    @pytest.mark.parametrize("B", range(1, 9))
    @pytest.mark.parametrize("K,N", [(100, 70), (37, 1000), (513, 1023),
                                     (4096, 517), (4096, 512), (300, 4100)])
    def test_batches_and_ragged_shapes(self, cuda_device, B, K, N):
        g = torch.Generator(device=cuda_device).manual_seed(B * K + N)
        x = torch.randn(B, K, device=cuda_device, generator=g)
        w = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                          device=cuda_device, generator=g)
        s = torch.rand(N, device=cuda_device, generator=g) * 1e-2
        n0 = tqk.wq_gemv.launches
        got = tqk.wq_gemv(x, w, s)
        assert tqk.wq_gemv.launches == n0 + 1
        want = tqk.wq_gemv_plain(x, w, s)
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())

    @pytest.mark.parametrize("offset", [1, 4, 8])
    def test_unaligned_weight_slice(self, cuda_device, offset):
        K, N = 300, 256
        buf = torch.randint(-127, 128, (K * N + offset,), dtype=torch.int8,
                            device=cuda_device)
        w = buf[offset:].view(K, N)
        x = torch.randn(5, K, device=cuda_device)
        s = torch.rand(N, device=cuda_device)
        got, want = tqk.wq_gemv(x, w, s), tqk.wq_gemv_plain(x, w, s)
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())

    @pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("K,N", [(4096, 4096), (2048, 1000)])
    def test_bf16_in_and_out(self, cuda_device, out, K, N):
        x = torch.randn(8, K, device=cuda_device).bfloat16()
        w = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                          device=cuda_device)
        s = torch.rand(N, device=cuda_device) * 1e-2
        got = tqk.wq_gemv(x, w, s, out_dtype=out)
        want = tqk.wq_gemv_plain(x, w, s, out_dtype=out)
        assert got.dtype == out
        tol = 1e-4 if out == torch.float32 else 1e-2
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * float(want.float().abs().max())

    @pytest.mark.parametrize("K,N", [(11008, 4096), (4096, 512),
                                     (4096, 64000)])
    def test_integer_operands_are_exact(self, cuda_device, K, N):
        # sums below 2^24: every output exact in float32, so a weight row
        # read twice or skipped shows where the 1e-4 check cannot see it
        g = torch.Generator(device=cuda_device).manual_seed(K + N)
        x = torch.randint(-8, 9, (8, K), device=cuda_device,
                          generator=g).float()
        w = torch.randint(-8, 9, (K, N), dtype=torch.int8,
                          device=cuda_device, generator=g)
        got = tqk.wq_gemv(x, w, torch.ones(N, device=cuda_device))
        want = (x.double() @ w.double()).float()
        assert torch.equal(got, want)

    def test_split_k_is_deterministic_and_leaves_counters_zero(
            self, cuda_device):
        K, N = 4096, 512
        x = torch.randn(8, K, device=cuda_device)
        w = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                          device=cuda_device)
        s = torch.rand(N, device=cuda_device)
        assert tqk.wq_plan(K, N, torch.cuda.get_device_properties(
            cuda_device).multi_processor_count)[1] > 1
        first = tqk.wq_gemv(x, w, s)
        for _ in range(3):
            assert torch.equal(tqk.wq_gemv(x, w, s), first)
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(cuda_device).cuda_stream
        _, counters = tk._split_k_scratch[(cuda_device.index
                                           or torch.cuda.current_device(),
                                           stream)]
        assert not counters.any()
