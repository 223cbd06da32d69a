"""The LM slice's three kernels against the JAX reference: ``int4_gemm``,
``int4_gemv`` and ``int8_flash_attention_fwd``.

Inputs come from numpy seeds and go to both packages; the reference runs
its Pallas kernels in interpret mode, the port its kernels' plain versions
on CPU tensors.  Tolerances, each with its reason:

  * ``int4_gemm`` / ``int4_gemv``: rtol 1e-5 and atol 1e-5 * max|out| --
    f32 sums in another order (the weight-only note of the int8 slice);
    the packing and unpacking themselves are EQUAL.
  * ``_per_head_quantize``: EQUAL payloads and scales; the card kernel's
    in-load formula (amax bits, ``max(amax, 1e-9) / 127``, the quotient
    by a reciprocal and one FMA correction, ``rint``) EQUALS it too.
  * the reordered int8 attention (every block's row maxes first, their
    prefix max, then each block's pq and PV, chained in block order):
    EQUAL to the plain version -- the same float32 operations on the same
    values.
  * int8 attention: 1e-2 * max|out| -- an ulp of ``exp`` can flip one
    ``round(p * 127)`` by one step; the observed error stays far below
    (``test_observed_error_is_small`` holds it to 1e-5).

The ``cuda``-marked tests hold each CUDA kernel against its plain version
on the card and skip here.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import (cuda_device, jax_alias, np_of, rand,  # noqa: F401
                           to_jax, to_torch)
from repro.kernels import flash_attention as jfa
from repro.kernels import quant_gemm as jqk
from repro.quant import qtensor as jqt
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import quant_gemm as tqk
from repro_torch.quant import qtensor as tqt

pytestmark = pytest.mark.usefixtures("jax_alias")

WO_TOL = 1e-5           # int4 weight-only: f32 reordering
ATTN_TOL = 1e-2         # x max|out|: one requantization step of p
ATTN_SAME_TOL = 1e-5    # x max|out|: no step apart, the roundings alone


def _int4(seed: int, K: int, N: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-8, 8, (K, N)).astype(np.int8)


def _scale(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(1e-3, 2e-2, n).astype(
        np.float32)


def _close_wo(got, want):
    scale = float(np.abs(np_of(want)).max())
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=WO_TOL,
                               atol=WO_TOL * scale)


def _packed_pair(seed, K, N):
    q = _int4(seed, K, N)
    packed_j = jqt.pack_int4(to_jax(q), axis=0)
    packed_t = tqt.pack_int4(to_torch(q), axis=0)
    return q, packed_j, packed_t


# ---------------------------------------------------------------------------
# int4_gemm / int4_gemv
# ---------------------------------------------------------------------------


class TestInt4:
    @pytest.mark.parametrize("K", [1, 2, 7, 15, 16, 33])
    def test_packing_equals_reference(self, K):
        q, packed_j, packed_t = _packed_pair(K, K, 5)
        np.testing.assert_array_equal(np_of(packed_t), np_of(packed_j))
        np.testing.assert_array_equal(
            np_of(tqt.unpack_int4(packed_t, K, axis=0)), q)

    # odd K, K below the block, N off the block, M in {1, 8, 9, 33}
    @pytest.mark.parametrize("M,K,N,block", [
        (9, 33, 70, (8, 16, 32)),
        (33, 97, 129, (16, 32, 64)),
        (9, 15, 300, (8, 512, 128)),
        (33, 64, 48, (16, 16, 16)),
        (1, 31, 40, (8, 8, 8)),
        (8, 50, 33, (8, 16, 16)),
    ], ids=["oddK", "oddK_raggedN", "K_below_bk", "even", "M1", "M8"])
    def test_gemm_matches_reference(self, M, K, N, block):
        _, packed_j, packed_t = _packed_pair(M + K, K, N)
        a, s = rand(K + N, M, K), _scale(N, N)
        want = jqk.int4_gemm(to_jax(a), packed_j, to_jax(s), k_size=K,
                             block=block, interpret=True)
        got = tqk.int4_gemm(to_torch(a), packed_t, to_torch(s), k_size=K)
        assert got.shape == (M, N) and got.dtype == torch.float32
        _close_wo(got, want)

    @pytest.mark.parametrize("B,K,N,block_k,block_n", [
        (1, 33, 70, 16, 32),
        (8, 97, 129, 32, 64),
        (8, 15, 300, 512, 1024),
        (5, 64, 48, 7, 16),
        (8, 600, 40, 512, 1024),
    ], ids=["B1_oddK", "B8_raggedN", "K_below_bk", "odd_block_k",
            "two_K_blocks"])
    def test_gemv_matches_reference(self, B, K, N, block_k, block_n):
        _, packed_j, packed_t = _packed_pair(B + K, K, N)
        x, s = rand(K + 1, B, K), _scale(N + 1, N)
        want = jqk.int4_gemv(to_jax(x), packed_j, to_jax(s), k_size=K,
                             block_k=block_k, block_n=block_n,
                             interpret=True)
        got = tqk.int4_gemv(to_torch(x), packed_t, to_torch(s), k_size=K,
                            block_k=block_k)
        assert got.shape == (B, N)
        _close_wo(got, want)

    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kernel", ["int4_gemm", "int4_gemv"])
    def test_bf16_lhs_matches_reference(self, kernel, out):
        # a bfloat16 lhs: the reference casts the unpacked weight to it
        # (exact) and sums in f32, as the port widens the lhs; a bfloat16
        # output is one rounding of the scaled f32 result (1e-2 * max|out|)
        M, K, N = (9, 33, 70) if kernel == "int4_gemm" else (5, 97, 129)
        _, packed_j, packed_t = _packed_pair(M + K + 1, K, N)
        a = to_torch(rand(K + 2, M, K)).bfloat16()
        aj = to_jax(a.float().numpy()).astype("bfloat16")
        s = _scale(N + 2, N)
        jdt, tdt = out, getattr(torch, out)
        if kernel == "int4_gemm":
            want = jqk.int4_gemm(aj, packed_j, to_jax(s), k_size=K,
                                 block=(8, 16, 32), out_dtype=jdt,
                                 interpret=True)
            got = tqk.int4_gemm(a, packed_t, to_torch(s), k_size=K,
                                out_dtype=tdt)
        else:
            want = jqk.int4_gemv(aj, packed_j, to_jax(s), k_size=K,
                                 block_k=32, block_n=64, out_dtype=jdt,
                                 interpret=True)
            got = tqk.int4_gemv(a, packed_t, to_torch(s), k_size=K,
                                block_k=32, out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (M, N)
        if out == "float32":
            _close_wo(got, want)
        else:
            want = np.asarray(want.astype("float32"))
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                       atol=1e-2 * float(np.abs(want).max()))

    def test_plain_versions_agree_with_dequantized_product(self):
        q, _, packed_t = _packed_pair(3, 21, 17)
        a, s = to_torch(rand(4, 9, 21)), to_torch(_scale(5, 17))
        want = (a.double() @ torch.from_numpy(q).double()).float() * s
        torch.testing.assert_close(
            tqk.int4_gemm_plain(a, packed_t, s, k_size=21), want,
            rtol=1e-5, atol=1e-5 * float(want.abs().max()))

    def test_rejects_bad_packing(self):
        a = torch.zeros(4, 9)
        with pytest.raises(ValueError, match="ceil"):
            tqk.int4_gemm(a, torch.zeros(4, 3, dtype=torch.int8),
                          torch.ones(3), k_size=9)
        with pytest.raises(ValueError, match="ceil"):
            tqk.int4_gemv(a, torch.zeros(5, 3, dtype=torch.float32),
                          torch.ones(3), k_size=9)
        with pytest.raises(ValueError, match="scale"):
            tqk.int4_gemm(a, torch.zeros(5, 3, dtype=torch.int8),
                          torch.ones(4), k_size=9)


# ---------------------------------------------------------------------------
# int8 flash attention
# ---------------------------------------------------------------------------


def _engine_mask(B, T, S, seed):
    """The cached path's mask: slot b sees its first ``lens[b]`` cache
    entries and its chunk causally; a slot with lens 0 has its leading
    kv blocks fully masked."""
    lens = np.random.default_rng(seed).integers(0, S + 1, B)
    lens[0] = 0
    j = np.arange(S + T)
    t = np.arange(T)
    old = (j[None, None, :] < lens[:, None, None]) & (j < S)
    new = (j[None, None, :] >= S) & (j[None, None, :] - S <= t[None, :, None])
    return old | new


def _attn_case(seed, B, H, KvH, T, Skv, dh=16):
    return (rand(seed, B, H, T, dh), rand(seed + 1, B, KvH, Skv, dh),
            rand(seed + 2, B, KvH, Skv, dh))


# (id, B, H, KvH, T, S, block_q, block_kv, seed): Skv = S + T
REORDER_CASES = [
    ("ragged_last_block", 2, 4, 2, 3, 18, 4, 8, 1),   # 21 = 2 x 8 + 5
    ("rep8_decode", 3, 16, 2, 1, 40, 1, 16, 2),
    ("rep8_prefill", 2, 8, 1, 16, 37, 16, 16, 3),     # slot 0: lens 0
    ("padded_rows", 2, 4, 1, 5, 11, 4, 4, 4),         # 5 rows, bq 4
    ("one_block", 2, 2, 2, 2, 5, 2, 8, 5),
]


def _rn32(fr: Fraction) -> np.float32:
    """The float32 nearest the rational ``fr`` (ties to even), exactly."""
    f = np.float32(float(fr))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - fr),
                                     int(np.float32(c).view(np.uint32)) & 1))


def _fma32(a, b, c) -> np.float32:
    """a * b + c in float32, rounded once (the card's FMA)."""
    return _rn32(Fraction(float(a)) * Fraction(float(b))
                 + Fraction(float(c)))


def _reordered_attention(q, k, v, mask, *, block_q, block_kv):
    """``int8_flash_attention``'s function in the card kernel's order, in
    float32 on the CPU with the plain version's shapes: all blocks' scores
    and row maxes, the running max through block j as their prefix max,
    then each block's pq, row sums and int32 PV against it, and last the
    chain of l and acc through the blocks in order."""
    B, H, Sq, dh = q.shape
    KvH, Skv = k.shape[1], k.shape[2]
    rep = H // KvH
    bq, bkv = tfa._blocks(Sq, Skv, block_q, block_kv)
    qq, kq, vq, mask, sqk, sv = tfa._prepare(q, k, v, mask, True, None)
    q_pad, kv_pad = (-Sq) % bq, (-Skv) % bkv
    qf = F.pad(qq.double(), (0, 0, 0, q_pad))
    kf = F.pad(kq.double(), (0, 0, 0, kv_pad)).repeat_interleave(rep, dim=1)
    vf = F.pad(vq.double(), (0, 0, 0, kv_pad)).repeat_interleave(rep, dim=1)
    maskp = F.pad(mask, (0, kv_pad, 0, q_pad))[:, None]
    s_qk = sqk[None, :, None, None]
    s_v = (sv / 127.0).repeat_interleave(rep)[None, :, None, None]
    blocks = range(0, Skv + kv_pad, bkv)
    scores = [torch.where(
        maskp[..., j:j + bkv],
        torch.matmul(qf, kf[:, :, j:j + bkv].transpose(-1, -2)).float()
        * s_qk, tfa._NEG_INF) for j in blocks]
    m = [torch.full((B, H, Sq + q_pad, 1), tfa._NEG_INF)]
    for s in scores:                     # prefix max of the block maxes
        m.append(torch.maximum(m[-1], s.amax(dim=-1, keepdim=True)))
    pq = [torch.round(torch.exp(s - m[i + 1]) * 127.0)
          for i, s in enumerate(scores)]
    lsum = [p.sum(dim=-1, keepdim=True) for p in pq]
    pv = [torch.matmul(p.double(), vf[:, :, j:j + bkv]).float()
          for p, j in zip(pq, blocks)]
    l = torch.zeros_like(m[0])
    acc = torch.zeros((B, H, Sq + q_pad, dh))
    for i in range(len(scores)):         # the chain, in block order
        corr = torch.exp(m[i] - m[i + 1])
        l = l * corr + lsum[i] / 127.0
        acc = acc * corr + pv[i] * s_v
    out = acc / torch.clamp(l, min=1e-30)
    return out[:, :, :Sq].to(q.dtype)


class TestInt8Attention:
    def test_per_head_quantize_equals_reference(self):
        x = rand(7, 2, 3, 11, 16) * 3
        qj, sj = jfa._per_head_quantize(to_jax(x))
        qt_, st = tfa._per_head_quantize(to_torch(x))
        np.testing.assert_array_equal(np_of(qt_), np_of(qj))
        np.testing.assert_array_equal(np_of(st), np_of(sj))

    # decode (T = 1) and prefill (T = 16), rep in {1, 2, 4}, Skv off the
    # kv block
    @pytest.mark.parametrize("T", [1, 16])
    @pytest.mark.parametrize("rep", [1, 2, 4])
    def test_engine_mask_matches_reference(self, T, rep):
        B, KvH, S = 3, 2, 21
        q, k, v = _attn_case(10 * rep + T, B, KvH * rep, KvH, T, S + T)
        mask = _engine_mask(B, T, S, rep)
        kw = dict(mask=mask, block_q=min(8, T), block_kv=8)
        want = jfa.int8_flash_attention_fwd(
            to_jax(q), to_jax(k), to_jax(v), interpret=True,
            **dict(kw, mask=to_jax(mask)))
        got = tfa.int8_flash_attention_fwd(
            to_torch(q), to_torch(k), to_torch(v),
            **dict(kw, mask=torch.from_numpy(mask)))
        scale = float(np.abs(np_of(want)).max())
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=0,
                                   atol=ATTN_TOL * scale)

    @pytest.mark.parametrize("Sq,Skv,bq,bkv", [(5, 5, 4, 4), (13, 13, 8, 8),
                                               (3, 10, 2, 4)])
    def test_causal_default_matches_reference(self, Sq, Skv, bq, bkv):
        q, k, v = _attn_case(Sq + Skv, 2, 4, 2, Sq, Skv)
        want = jfa.int8_flash_attention_fwd(
            to_jax(q), to_jax(k), to_jax(v), block_q=bq, block_kv=bkv,
            interpret=True)
        got = tfa.int8_flash_attention_fwd(
            to_torch(q), to_torch(k), to_torch(v), block_q=bq, block_kv=bkv)
        scale = float(np.abs(np_of(want)).max())
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=0,
                                   atol=ATTN_TOL * scale)

    def test_observed_error_is_small(self):
        # the engine-shaped case at the layers' blocks (min(128, .)); the
        # plain version repeats the reference's arithmetic, so the error
        # seen is float rounding, far inside the 1e-2 budget
        B, H, KvH, T, S = 4, 8, 2, 16, 40
        q, k, v = _attn_case(3, B, H, KvH, T, S + T)
        mask = _engine_mask(B, T, S, 4)
        want = jfa.int8_flash_attention_fwd(
            to_jax(q), to_jax(k), to_jax(v), mask=to_jax(mask),
            block_q=T, block_kv=S + T, interpret=True)
        got = tfa.int8_flash_attention_fwd(
            to_torch(q), to_torch(k), to_torch(v),
            mask=torch.from_numpy(mask), block_q=T, block_kv=S + T)
        err = float(np.abs(np_of(got) - np_of(want)).max())
        assert err <= 1e-5 * float(np.abs(np_of(want)).max())

    def test_block_structure_is_part_of_the_function(self):
        # p is requantized against the running max of each kv block, so
        # another kv block size gives another (close) result -- the plain
        # version must walk the reference's blocks, not softmax at once
        q, k, v = (to_torch(x) for x in _attn_case(5, 1, 2, 1, 4, 64))
        a = tfa.int8_flash_attention_fwd(4 * q, k, v, causal=False,
                                         block_kv=8)
        b = tfa.int8_flash_attention_fwd(4 * q, k, v, causal=False,
                                         block_kv=64)
        assert not torch.equal(a, b)
        assert float((a - b).abs().max()) < 0.1 * float(b.abs().max())

    def test_operands_reach_the_kernel_contiguous(self):
        # the layers pass (B, T, H, dh) -> (B, H, T, dh) transposed views;
        # the kernel's int8 payloads must still be contiguous
        q = to_torch(rand(2, 2, 3, 4, 16)).transpose(1, 2)   # (B, H, T, dh)
        k, v = (to_torch(rand(s, 2, 6, 4, 16)).transpose(1, 2)
                for s in (3, 4))
        assert not q.is_contiguous()
        qq, kq, vq, mask, sqk, sv = tfa._prepare(q, k, v, None, True, None)
        assert all(t.is_contiguous() for t in (qq, kq, vq, mask, sqk, sv))
        assert (qq.shape, kq.shape, sqk.shape, sv.shape) == \
            ((2, 4, 3, 16), (2, 4, 6, 16), (4,), (4,))

    @pytest.mark.parametrize("dtype", [np.float32, "bf16"])
    def test_in_load_quantization_equals_per_head_quantize(self, dtype):
        # the card kernel's formula in float32, each FMA rounded once
        # (exactly, through Fraction): a head's amax as the largest |x|
        # bit pattern (non-negative floats order as integers), scale =
        # max(amax, 1e-9) / 127, inv = RN(1 / scale), y = RN(x * inv), q
        # = RN(RN(x - scale * y) * inv + y), rint(q); and sqk = (sq *
        # sk[g]) * sm_scale.  Head 0 holds values next to every
        # half-integer step, where rint tells RN(x / scale) from a
        # quotient one ulp off.
        x = rand(11, 3, 4, 32, 16)
        amax = np.float32(3.0)
        sc0 = np.maximum(amax, np.float32(1e-9)) / np.float32(127)
        near = np.float32(np.arange(-127, 127) + 0.5) * sc0
        near = np.concatenate([np.nextafter(near, np.float32(d * np.inf))
                               for d in (-1, 1)] + [near])
        head0 = np.clip(x[:, 0].reshape(-1), -2.5, 2.5)
        head0[:near.size] = near
        head0[near.size] = amax
        x[:, 0] = head0.reshape(x[:, 0].shape)
        x = to_torch(x)
        if dtype == "bf16":
            x = x.bfloat16()
        xf = x.float().numpy()
        bits = np.abs(xf).view(np.uint32).max(axis=(0, 2, 3))
        amax = bits.view(np.float32)
        assert np.array_equal(amax, np.abs(xf).max(axis=(0, 2, 3)))
        scale = np.maximum(amax, np.float32(1e-9)) / np.float32(127)
        inv = np.float32(1) / scale
        q8 = np.empty(xf.shape, np.float32)
        for h in range(xf.shape[1]):
            for idx, xv in np.ndenumerate(xf[:, h]):
                y = np.float32(xv * inv[h])
                q = _fma32(_fma32(-scale[h], y, xv), inv[h], y)
                q8[idx[0], h, idx[1], idx[2]] = np.rint(q)
        assert np.abs(q8).max() <= 127
        scale = scale[None, :, None, None]
        qt_, st = tfa._per_head_quantize(x)
        np.testing.assert_array_equal(q8.astype(np.int8), np_of(qt_))
        np.testing.assert_array_equal(scale[0, :, 0, 0], np_of(st)[:, 0])
        # the combined score scale of the wrapper's plain path
        k = to_torch(rand(12, 3, 2, 32, 16))
        _, _, _, _, sqk, _ = tfa._prepare(x.float(), k, k, None, True, 0.3)
        sk = np.maximum(np.abs(k.numpy()).max(axis=(0, 2, 3)),
                        np.float32(1e-9)) / np.float32(127)
        want = (scale[0, :, 0, 0] * sk[np.arange(4) // 2]) * np.float32(0.3)
        np.testing.assert_array_equal(want.astype(np.float32), np_of(sqk))

    @pytest.mark.parametrize("case", REORDER_CASES, ids=[
        c[0] for c in REORDER_CASES])
    def test_reordered_attention_equals_plain(self, case):
        # the card kernel's order: all kv blocks' row maxes at once, the
        # running max as their prefix max, each block's pq / row sums / PV
        # from it, then l and acc chained in block order -- bit for bit
        # the plain version's in-order loop, and the reference within
        # ATTN_TOL
        _, B, H, KvH, T, S, bq, bkv, seed = case
        q, k, v = _attn_case(seed, B, H, KvH, T, S + T)
        mask = _engine_mask(B, T, S, seed)
        kw = dict(block_q=bq, block_kv=bkv)
        got = _reordered_attention(to_torch(q), to_torch(k), to_torch(v),
                                   torch.from_numpy(mask), **kw)
        want = tfa.int8_flash_attention_plain(
            to_torch(q), to_torch(k), to_torch(v),
            mask=torch.from_numpy(mask), **kw)
        assert torch.equal(got, want)
        ref = jfa.int8_flash_attention_fwd(
            to_jax(q), to_jax(k), to_jax(v), mask=to_jax(mask),
            interpret=True, **kw)
        scale = float(np.abs(np_of(ref)).max())
        np.testing.assert_allclose(np_of(got), np_of(ref), rtol=0,
                                   atol=ATTN_TOL * scale)

    def test_rejects_bad_mask(self):
        q, k, v = (to_torch(x) for x in _attn_case(1, 1, 2, 1, 3, 5))
        with pytest.raises(ValueError, match="mask"):
            tfa.int8_flash_attention_fwd(q, k, v,
                                         mask=torch.ones(1, 3, 4, dtype=bool))


# ---------------------------------------------------------------------------
# on the card (skip here)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("M,K,N", [(128, 4096, 512), (33, 97, 129),
                                       (9, 15, 300)])
    def test_int4_gemm(self, cuda_device, M, K, N):
        g = torch.Generator(device=cuda_device).manual_seed(0)
        q = torch.randint(-8, 8, (K, N), generator=g, device=cuda_device,
                          dtype=torch.int8)
        w = tqt.pack_int4(q, axis=0).contiguous()
        a = torch.randn(M, K, generator=g, device=cuda_device)
        s = torch.rand(N, generator=g, device=cuda_device) + 0.1
        got = tqk.int4_gemm(a, w, s, k_size=K)
        want = tqk.int4_gemm_plain(a, w, s, k_size=K)
        torch.testing.assert_close(got, want, rtol=WO_TOL,
                                   atol=WO_TOL * float(want.abs().max()))

    @pytest.mark.parametrize("B,K,N", [(8, 4096, 4096), (1, 33, 70),
                                       (5, 11008, 512)])
    def test_int4_gemv(self, cuda_device, B, K, N):
        g = torch.Generator(device=cuda_device).manual_seed(1)
        q = torch.randint(-8, 8, (K, N), generator=g, device=cuda_device,
                          dtype=torch.int8)
        w = tqt.pack_int4(q, axis=0).contiguous()
        x = torch.randn(B, K, generator=g, device=cuda_device)
        s = torch.rand(N, generator=g, device=cuda_device) + 0.1
        got = tqk.int4_gemv(x, w, s, k_size=K)
        want = tqk.int4_gemv_plain(x, w, s, k_size=K)
        torch.testing.assert_close(got, want, rtol=WO_TOL,
                                   atol=WO_TOL * float(want.abs().max()))

    # the shapes the tensor-core tile makes hard: odd K (a zero high
    # nibble), N off the 16-byte copy and the 128-column block, K split
    # over CTAs, every batch the n8 columns hold
    @pytest.mark.parametrize("B", [1, 5, 8])
    @pytest.mark.parametrize("K,N", [(97, 129), (4097, 1000), (11008, 512),
                                     (33, 70), (4096, 4104)])
    def test_int4_gemv_ragged(self, cuda_device, B, K, N):
        g = torch.Generator(device=cuda_device).manual_seed(B * K + N)
        q = torch.randint(-8, 8, (K, N), generator=g, device=cuda_device,
                          dtype=torch.int8)
        w = tqt.pack_int4(q, axis=0).contiguous()
        x = torch.randn(B, K, generator=g, device=cuda_device)
        s = torch.rand(N, generator=g, device=cuda_device) + 0.1
        n0 = tqk.int4_gemv.launches
        got = tqk.int4_gemv(x, w, s, k_size=K)
        assert tqk.int4_gemv.launches == n0 + 1
        want = tqk.int4_gemv_plain(x, w, s, k_size=K)
        torch.testing.assert_close(got, want, rtol=WO_TOL,
                                   atol=WO_TOL * float(want.abs().max()))

    @pytest.mark.parametrize("K,N", [(11008, 4096), (4096, 512), (97, 129)])
    def test_int4_gemv_integer_operands_are_exact(self, cuda_device, K, N):
        # sums below 2^24: every output exact in float32, so a nibble read
        # twice or skipped, or a chunk starting mid-byte, shows
        g = torch.Generator(device=cuda_device).manual_seed(K + N)
        x = torch.randint(-8, 9, (8, K), device=cuda_device,
                          generator=g).float()
        q = torch.randint(-8, 8, (K, N), generator=g, device=cuda_device,
                          dtype=torch.int8)
        w = tqt.pack_int4(q, axis=0).contiguous()
        got = tqk.int4_gemv(x, w, torch.ones(N, device=cuda_device),
                            k_size=K)
        assert torch.equal(got, (x.double() @ q.double()).float())

    @pytest.mark.parametrize("M", [1, 8, 128])
    def test_int4_bf16(self, cuda_device, M):
        # a bfloat16 lhs (int4_gemv at or below 8 rows, int4_gemm above)
        # and both output dtypes
        K, N = 4096, 512
        g = torch.Generator(device=cuda_device).manual_seed(M)
        q = torch.randint(-8, 8, (K, N), generator=g, device=cuda_device,
                          dtype=torch.int8)
        w = tqt.pack_int4(q, axis=0).contiguous()
        a = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        s = torch.rand(N, generator=g, device=cuda_device) + 0.1
        fn, plain = ((tqk.int4_gemv, tqk.int4_gemv_plain) if M <= 8
                     else (tqk.int4_gemm, tqk.int4_gemm_plain))
        for out in (torch.float32, torch.bfloat16):
            got = fn(a, w, s, k_size=K, out_dtype=out)
            want = plain(a, w, s, k_size=K, out_dtype=out)
            assert got.dtype == out
            tol = WO_TOL if out == torch.float32 else 1e-2
            assert float((got.float() - want.float()).abs().max()) <= \
                tol * float(want.float().abs().max())

    @pytest.mark.parametrize("T", [1, 16, 130])
    def test_int8_attention(self, cuda_device, T):
        B, H, KvH, S, dh = 4, 8, 2, 200, 128
        g = torch.Generator(device=cuda_device).manual_seed(T)
        q = torch.randn(B, H, T, dh, generator=g, device=cuda_device)
        k, v = (torch.randn(B, KvH, S + T, dh, generator=g,
                            device=cuda_device) for _ in range(2))
        mask = torch.from_numpy(_engine_mask(B, T, S, T)).to(cuda_device)
        kw = dict(mask=mask, block_q=min(128, T), block_kv=128)
        got = tfa.int8_flash_attention_fwd(q, k, v, **kw)
        want = tfa.int8_flash_attention_plain(q, k, v, **kw)
        assert float((got - want).abs().max()) <= \
            ATTN_TOL * float(want.abs().max())

    @pytest.mark.parametrize("T", [1, 16])
    def test_int8_attention_engine_layout(self, cuda_device, T):
        # Yi-9B's call at 8 slots: q (B, T, H, dh) float32 and the bf16
        # cache (B, S + T, KvH, dh) passed transposed, as models/layers.py
        # passes them; the kernels read the strides as they are
        B, H, KvH, S, dh = 8, 32, 4, 512, 128
        g = torch.Generator(device=cuda_device).manual_seed(10 + T)
        q = torch.randn(B, T, H, dh, generator=g, device=cuda_device)
        k, v = (torch.randn(B, S + T, KvH, dh, generator=g,
                            device=cuda_device).bfloat16()
                for _ in range(2))
        mask = torch.from_numpy(_engine_mask(B, T, S, T)).to(cuda_device)
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        kw = dict(mask=mask, scale=dh ** -0.5, block_q=T,
                  block_kv=min(128, S + T))
        n0 = tfa.int8_flash_attention_fwd.launches
        got = tfa.int8_flash_attention_fwd(*args, **kw)
        assert tfa.int8_flash_attention_fwd.launches == n0 + 1
        want = tfa.int8_flash_attention_plain(*args, **kw)
        assert got.dtype == torch.float32 and got.shape == (B, H, T, dh)
        assert float((got - want).abs().max()) <= \
            ATTN_TOL * float(want.abs().max())
        # a bfloat16 q gives a bfloat16 output, rounded once
        got16 = tfa.int8_flash_attention_fwd(args[0].bfloat16(), *args[1:],
                                             **kw)
        want16 = tfa.int8_flash_attention_plain(args[0].bfloat16(),
                                                *args[1:], **kw)
        assert got16.dtype == torch.bfloat16
        assert float((got16.float() - want16.float()).abs().max()) <= \
            ATTN_TOL * float(want16.float().abs().max())

    @pytest.mark.parametrize("H,KvH,dh", [(32, 32, 112), (14, 2, 64)])
    @pytest.mark.parametrize("T", [1, 16])
    def test_int8_attention_head_dims(self, cuda_device, H, KvH, dh, T):
        # Zamba2-7B's shared block (dh 112, a KV head for each query head)
        # and InternVL2-1B (dh 64, seven query heads a KV head) at 8 slots
        # on the bf16 cache: no requantized step apart from the plain
        # version, whose divisions by 127 are exact on the card, as the
        # kernel's are
        B, S = 8, 512
        g = torch.Generator(device=cuda_device).manual_seed(H + dh + T)
        q = torch.randn(B, H, T, dh, generator=g, device=cuda_device)
        k, v = (torch.randn(B, KvH, S + T, dh, generator=g,
                            device=cuda_device).bfloat16()
                for _ in range(2))
        mask = torch.from_numpy(_engine_mask(B, T, S, T)).to(cuda_device)
        kw = dict(mask=mask, block_q=T, block_kv=128)
        got = tfa.int8_flash_attention_fwd(q, k, v, **kw)
        want = tfa.int8_flash_attention_plain(q, k, v, **kw)
        assert float((got - want).abs().max()) <= \
            ATTN_SAME_TOL * float(want.abs().max())

    @pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
    def test_amax_scales_are_exact(self, cuda_device, kv_dtype):
        # the first launch's per-head amax gives _per_head_quantize's
        # scales bit for bit, and the launch pair leaves the workspace zero
        g = torch.Generator(device=cuda_device).manual_seed(3)
        q = torch.randn(4, 8, 16, 128, generator=g, device=cuda_device) * 3
        k, v = (torch.randn(4, 2, 300, 128, generator=g, device=cuda_device)
                .to(kv_dtype) for _ in range(2))
        amax = tfa.head_amax(q, k, v)
        for x, a in zip((q, k, v), amax):
            _, want = tfa._per_head_quantize(x)
            assert torch.equal(tfa._div(torch.clamp(a, min=tfa._EPS),
                                        127.0), want[:, 0])
        tfa.int8_flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        assert all(int(ws.abs().sum()) == 0
                   for ws in tfa._attn_scratch.values())

    def test_no_plain_version_on_the_card(self, cuda_device, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("the plain version ran on CUDA tensors")
        monkeypatch.setattr(tfa, "int8_flash_attention_plain", refuse)
        monkeypatch.setattr(tfa, "_per_head_quantize", refuse)
        q = torch.randn(2, 4, 3, 64, device=cuda_device)
        k, v = (torch.randn(2, 2, 40, 64, device=cuda_device)
                for _ in range(2))
        assert tfa.int8_flash_attention_fwd(q, k, v).isfinite().all()
