"""The port's float GEMV, ``kernels.gemv.gemv`` (``csrc/gemv.cu``): its
planner (``gemv_plan``, ``gemv_cost``, ``gemv_vec``), its constants against
the source, and a numpy model of what the kernel computes, held against
the plain version and the JAX kernel in interpret mode.

The model runs on the CPU the kernel's K walk: each CTA's K chunk (from
``gemv_plan``) in stages of 16 KB of weight (32 float32 or 64 bfloat16
rows), each stage's rows 4 at a time, group g taken by warp g % 8, each
warp's products summed in float32 in row order (a group's four in
float64, then rounded: the kernel's fmaf chain is its own), the 8 warps'
sums added in warp order, then the split-K planes in plane order.  It is
held within 1e-5 * max|out| of the plain version and of the JAX kernel
(float32 sums in another order), and EQUAL to the exact product on
integer-valued operands whose sums stay below 2^24, where every order is
exact and a row read twice or skipped shows.  The kernel itself runs on
the card in ``tests/test_torch_kernels.py::TestOnCard::test_gemv``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_alias, to_jax  # noqa: F401
from repro.kernels import gemv as j_gemv
from repro_torch import kernels as tk
from repro_torch.core import hw
from repro_torch.kernels import _build
from repro_torch.kernels import gemv as tg
from repro_torch.kernels import quant_gemm as tqk

pytestmark = pytest.mark.usefixtures("jax_alias")

SMS = 132                      # an H100 SXM's SMs
RTOL = 1e-5                    # x max|out|: float32 sums in another order
WARPS = tg.GEMV_THREADS // 32  # K split over a CTA's warps
GROUP = 4                      # csrc/gemv.cu kGroup: rows a warp takes at once

# Yi-9B's decode projections and head (K, N), the ResNet50 and MobileNetV1
# heads
DECODE_SHAPES = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
                 (4096, 64000)]
HEAD_SHAPES = [(2048, 1000), (1024, 1000)]
# K chunks at M = 8, float32: the split tools/split_sweep.py --gemv
# measured fastest at each on an H100 80GB HBM3, or within 4 % of it (gate
# / up: 3, 0.8 % from 1; the ResNet50 head: 11, 3.7 % from 8)
SWEEP_PICKS = {(4096, 4096): 4, (4096, 512): 16, (4096, 11008): 3,
               (11008, 4096): 4, (4096, 64000): 1, (2048, 1000): 11,
               (1024, 1000): 8}
RAGGED_SHAPES = [(1, 7), (37, 1000), (100, 70), (513, 1023), (300, 4100),
                 (65, 129), (4099, 517), (100_000, 256)]


def _stage_rows(elem_bytes: int) -> int:
    return tg.GEMV_STAGE_BYTES // (tg.GEMV_COLS * elem_bytes)


def _rows_of_chunk(length: int, elem_bytes: int) -> np.ndarray:
    """Row r of a CTA's chunk -> how many (stage, group, row) of the
    kernel's warps read it: warp w takes group g * 8 + w of each stage,
    rows 4 (g * 8 + w) + i, i < 4; rows past the chunk are zeros in x and
    the weight, so they add nothing."""
    rows = _stage_rows(elem_bytes)
    s, g, w, i = np.meshgrid(np.arange(-(-length // rows)),
                             np.arange(rows // (GROUP * WARPS)),
                             np.arange(WARPS), np.arange(GROUP),
                             indexing="ij")
    r = (s * rows + (g * WARPS + w) * GROUP + i).ravel()
    return np.bincount(r[r < length], minlength=length)


def _gemv_by_ctas(x, w, plan, elem_bytes: int) -> np.ndarray:
    """``gemv`` as the kernel computes it: per CTA (column block, K chunk)
    each warp's groups in stage order, the 8 warps' float32 sums in warp
    order, then the planes in order."""
    x, w = np.asarray(x, np.float64), np.asarray(w, np.float64)
    B, K = x.shape
    N = w.shape[1]
    kc, ks = plan
    rows = _stage_rows(elem_bytes)
    planes = np.zeros((ks, B, N), np.float32)
    for cy in range(ks):
        k0 = cy * kc
        end = min(K, k0 + kc)
        acc = np.zeros((WARPS, B, N), np.float32)
        for s in range(-(-(end - k0) // rows)):
            for g in range(rows // (GROUP * WARPS)):
                for wi in range(WARPS):
                    r0 = k0 + s * rows + (g * WARPS + wi) * GROUP
                    rr = slice(r0, min(end, r0 + GROUP))
                    acc[wi] = (acc[wi] + x[:, rr] @ w[rr]).astype(np.float32)
        tot = acc[0]
        for wi in range(1, WARPS):
            tot = tot + acc[wi]
        planes[cy] = tot
    out = planes[0]
    for p in range(1, ks):
        out = out + planes[p]
    return out


class TestGemvPlan:
    @pytest.mark.parametrize("elem_bytes", [4, 2])
    @pytest.mark.parametrize("K,N", DECODE_SHAPES + HEAD_SHAPES
                             + RAGGED_SHAPES)
    def test_chunks_cover_k_once(self, K, N, elem_bytes):
        kc, ks = tg.gemv_plan(K, N, SMS, elem_bytes)
        assert kc * (ks - 1) < K <= kc * ks <= K + kc - 1
        assert ks == 1 or kc % tg.GEMV_CHUNK_ROWS == 0
        chunks = np.concatenate([k0 + np.flatnonzero(_rows_of_chunk(
            min(K, k0 + kc) - k0, elem_bytes)) for k0 in range(0, K, kc)])
        assert np.array_equal(chunks, np.arange(K))
        for k0 in range(0, K, kc):
            assert (_rows_of_chunk(min(K, k0 + kc) - k0, elem_bytes)
                    == 1).all()

    @pytest.mark.parametrize("elem_bytes", [4, 2])
    @pytest.mark.parametrize("K,N", DECODE_SHAPES + HEAD_SHAPES)
    def test_picks_the_least_modeled_cost(self, K, N, elem_bytes):
        kc, ks = tg.gemv_plan(K, N, SMS, elem_bytes)
        cands = [K] + [tg.GEMV_CHUNK_ROWS * m for m in range(
            1, -(-K // tg.GEMV_CHUNK_ROWS))
            if -(-K // (tg.GEMV_CHUNK_ROWS * m)) <= tg.GEMV_MAX_SPLIT]
        assert tg.gemv_cost(K, N, SMS, kc, elem_bytes) == min(
            tg.gemv_cost(K, N, SMS, c, elem_bytes) for c in cands)
        # a CTA pays whole stages: one chunk of a stage's rows and one more
        # costs what two whole stages cost
        rows = _stage_rows(elem_bytes)
        assert tg.gemv_cost(rows + 1, N, SMS, rows + 1, elem_bytes) == \
            tg.gemv_cost(2 * rows, N, SMS, 2 * rows, elem_bytes)

    @pytest.mark.parametrize("K,N", [(4096, 512)] + HEAD_SHAPES)
    def test_narrow_column_blocks_split_k_part_way(self, K, N):
        # k / v and the vision heads: 4 or 8 column blocks; K splits, but
        # not until every SM holds its CTAs -- past a point the split-K
        # hand-off costs more than an idle SM
        blocks = -(-N // tg.GEMV_COLS)
        for eb in (4, 2):
            kc, ks = tg.gemv_plan(K, N, SMS, eb)
            assert 1 < ks and blocks * ks <= SMS * tg.GEMV_CTAS_PER_SM
            assert kc >= 64

    def test_wide_heads_split_k_little(self):
        # 500 column blocks already fill the card several times over
        assert tg.gemv_plan(4096, 64000, SMS, 4)[1] <= 2

    @pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008),
                                     (11008, 4096)])
    def test_projections_fill_the_card(self, K, N):
        # 32 or 86 column blocks: K splits until one more chunk a column
        # block would pass one CTA an SM
        kc, ks = tg.gemv_plan(K, N, SMS, 4)
        assert -(-N // tg.GEMV_COLS) * (ks + 1) > SMS

    @pytest.mark.parametrize("K,N", DECODE_SHAPES + HEAD_SHAPES)
    def test_picks_the_sweeps_split(self, K, N):
        # tools/split_sweep.py --gemv on an H100 80GB HBM3 (float32): the
        # split each shape ran fastest in, or one within 4 % of it
        assert tg.gemv_plan(K, N, SMS, 4)[1] == SWEEP_PICKS[(K, N)]

    @pytest.mark.parametrize("waves", [1, 2, 3])
    def test_whole_waves_need_no_split(self, waves):
        # column blocks that fill every SM the same number of times: a split
        # adds planes and CTA costs and evens nothing
        for eb in (4, 2):
            assert tg.gemv_plan(4096, tg.GEMV_COLS * SMS * waves, SMS,
                                eb)[1] == 1

    def test_an_uneven_last_wave_is_split(self):
        # the head on 66 SMs: 500 column blocks leave the last of 8 waves
        # 58 % full; three chunks a block even the SMs' loads
        kc, ks = tg.gemv_plan(4096, 64000, 66, 4)
        assert ks > 1

    def test_shared_memory_does_not_grow_with_k(self):
        # x streams through the ring with the weight: two CTAs an SM at any
        # K (each with the 1 KB the system keeps a CTA, of the SM's 228 KB),
        # and one CTA may walk all of a long K
        assert tg.GEMV_CTAS_PER_SM * (tg.GEMV_RING_BYTES + 16 + 1024) \
            <= hw.SMEM_PER_BLOCK + 1024
        for eb in (4, 2):
            kc, ks = tg.gemv_plan(100_000, 64000, SMS, eb)
            assert kc * ks >= 100_000 and ks <= tg.GEMV_MAX_SPLIT

    @pytest.mark.parametrize("N,elem_bytes,address,want", [
        (4096, 4, 0, 16), (1000, 4, 0, 16), (1000, 4, 4, 4),
        (1000, 4, 8, 8), (1023, 4, 0, 4), (64000, 2, 256, 16),
        (1000, 2, 0, 16), (1000, 2, 2, 2), (1002, 2, 0, 4),
        (1023, 2, 0, 2), (517, 4, 16, 4), (4100, 4, 0, 16)])
    def test_copy_width_falls_back(self, N, elem_bytes, address, want):
        # the ResNet50 head's float32 rows are 4000 bytes apart: 16-byte
        # copies; a ragged or unaligned weight takes narrower ones
        assert tg.gemv_vec(N, elem_bytes, address) == want

    def test_workspace_is_the_streaming_gemvs(self):
        # gemv, wq_gemv and int4_gemv share the per-stream planes and
        # counters (the counters are zero between launches)
        assert tg.split_k_workspace is tk.split_k_workspace
        assert tqk.split_k_workspace is tk.split_k_workspace

    def test_constants_match_the_source(self):
        src = (_build.CSRC / "gemv.cu").read_text()

        def const(name):
            return int(re.search(rf"constexpr int {name} = (\d+);",
                                 src).group(1))
        assert const("kCols") == tg.GEMV_COLS
        assert const("kThreads") == tg.GEMV_THREADS
        assert const("kStageBytes") == tg.GEMV_STAGE_BYTES
        assert const("kStages") == tg.GEMV_STAGES
        assert const("kCtasPerSm") == tg.GEMV_CTAS_PER_SM
        assert const("kMaxB") == tg.MAX_BATCH
        assert const("kGroup") == GROUP
        assert "kWarps = kThreads / 32;" in src
        # a slot: the stage's weight and its rows of x, 1 KB in both types
        for line in ("kRows = kStageBytes / (kCols * (int)sizeof(T));",
                     "kXBytes = kMaxB * kRows * (int)sizeof(T);",
                     "kSlot = kStageBytes + kXBytes;",
                     "kBytes = kStages * kSlot;"):
            assert line in src, line
        for eb in (4, 2):
            assert tg.MAX_BATCH * _stage_rows(eb) * eb == 1024
        assert tg.GEMV_RING_BYTES == tg.GEMV_STAGES * (
            tg.GEMV_STAGE_BYTES + 1024)
        tiles = src.split('extern "C" void gemv_tiles(')[1]
        assert "kRingBytes = Ring<float>::kBytes;" in tiles
        want = ("kCols", "kThreads", "kStageBytes", "kStages", "kRingBytes",
                "kCtasPerSm")
        assert re.findall(r"t\[\d\] = (\w+);", tiles) == list(want)

    def test_args_the_source_reads(self):
        # B, K, N, kc, ksplit, vec, in_bf16, out_bf16, as the wrapper
        # passes them
        src = (_build.CSRC / "gemv.cu").read_text().split(
            'extern "C" int gemv(')[1]
        reads = re.findall(r"(\w+) = args\[(\d+)\]", src)
        assert [int(i) for _, i in reads] == list(range(8))
        assert [n for n, _ in reads] == ["B", "K", "N", "kc", "ksplit",
                                         "vec", "in_bf16", "out_bf16"]

    def test_one_launch_a_call(self):
        # the split-K sum runs in the kernel's own launch: no second pass
        src = (_build.CSRC / "gemv.cu").read_text()
        assert "split_k_last_sum<" in src
        assert "launch_split_k_sum" not in src and "gemv_sum" not in src
        wq = (_build.CSRC / "wq_gemv.cuh").read_text()
        assert "split_k_last_sum<" in wq


class TestKWalkModel:
    """The kernel's K walk in numpy, held against the plain version and
    the JAX kernel."""

    @pytest.mark.parametrize("elem_bytes", [4, 2])
    @pytest.mark.parametrize("B,K,N", [(1, 37, 1000), (3, 1000, 300),
                                       (8, 2048, 1000), (8, 4096, 512),
                                       (5, 513, 1023), (8, 301, 129),
                                       (3, 4099, 70)])
    def test_model_matches_plain(self, B, K, N, elem_bytes):
        rng = np.random.default_rng(K + N + elem_bytes)
        x = rng.standard_normal((B, K)).astype(np.float32)
        w = rng.standard_normal((K, N)).astype(np.float32)
        got = _gemv_by_ctas(x, w, tg.gemv_plan(K, N, SMS, elem_bytes),
                            elem_bytes)
        want = tg.gemv_plain(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=RTOL * float(want.abs().max()))

    @pytest.mark.parametrize("B,K,N", [(1, 37, 1000), (3, 1000, 300),
                                       (8, 513, 1023), (8, 2049, 130)])
    def test_model_matches_pallas(self, B, K, N):
        rng = np.random.default_rng(B * K + N)
        x = rng.standard_normal((B, K)).astype(np.float32)
        w = rng.standard_normal((K, N)).astype(np.float32)
        got = _gemv_by_ctas(x, w, tg.gemv_plan(K, N, SMS, 4), 4)
        want = np.asarray(j_gemv.gemv(to_jax(x), to_jax(w), interpret=True))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * float(np.abs(want).max()))

    @pytest.mark.parametrize("B,K,N", [(8, 4096, 512), (3, 301, 129),
                                       (8, 2048, 1000), (1, 11008, 256)])
    def test_bf16_operands_match_pallas(self, B, K, N):
        # bfloat16 operands are widened exactly: the model on the rounded
        # values against the JAX kernel on bfloat16 operands, float32 out
        rng = np.random.default_rng(K * N)
        xb = jnp.asarray(rng.standard_normal((B, K)), jnp.bfloat16)
        wb = jnp.asarray(rng.standard_normal((K, N)), jnp.bfloat16)
        x, w = (np.asarray(v.astype(jnp.float32)) for v in (xb, wb))
        got = _gemv_by_ctas(x, w, tg.gemv_plan(K, N, SMS, 2), 2)
        want = np.asarray(j_gemv.gemv(xb, wb, out_dtype=jnp.float32,
                                      interpret=True))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * float(np.abs(want).max()))

    @pytest.mark.parametrize("elem_bytes", [4, 2])
    @pytest.mark.parametrize("B,K,N", [(8, 11008, 256), (2, 4096, 512),
                                       (7, 777, 1000), (1, 4099, 129)])
    def test_integer_operands_are_exact(self, B, K, N, elem_bytes):
        # |x|, |w| <= 8: |sum| <= 64 K < 2^24, exact in any order
        rng = np.random.default_rng(B * K + elem_bytes)
        x = rng.integers(-8, 9, (B, K)).astype(np.float32)
        w = rng.integers(-8, 9, (K, N)).astype(np.float32)
        got = _gemv_by_ctas(x, w, tg.gemv_plan(K, N, SMS, elem_bytes),
                            elem_bytes)
        want = (x.astype(np.float64) @ w.astype(np.float64)).astype(
            np.float32)
        assert np.array_equal(got, want)
