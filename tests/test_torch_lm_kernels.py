"""The LM slice's three kernels against the JAX reference: ``int4_gemm``,
``int4_gemv`` and ``int8_flash_attention_fwd``.

Inputs come from numpy seeds and go to both packages; the reference runs
its Pallas kernels in interpret mode, the port its kernels' plain versions
on CPU tensors.  Tolerances, each with its reason:

  * ``int4_gemm`` / ``int4_gemv``: rtol 1e-5 and atol 1e-5 * max|out| --
    f32 sums in another order (the weight-only note of the int8 slice);
    the packing and unpacking themselves are EQUAL.
  * ``_per_head_quantize``: EQUAL payloads and scales.
  * int8 attention: 1e-2 * max|out| -- an ulp of ``exp`` can flip one
    ``round(p * 127)`` by one step; the observed error stays far below
    (``test_observed_error_is_small`` holds it to 1e-5).

The ``cuda``-marked tests hold each CUDA kernel against its plain version
on the card and skip here.
"""
import numpy as np
import pytest
import torch

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

    @pytest.mark.parametrize("K,N,sms,block_k", [
        (4096, 4096, 132, 512), (11008, 512, 132, 512), (33, 70, 132, 7),
        (4097, 64000, 132, 512), (15, 300, 132, 512)])
    def test_split_k_chunks_start_on_whole_bytes(self, K, N, sms, block_k):
        kc, ksplit = tqk.int4_split_k(K, N, sms, block_k)
        assert kc * ksplit >= K and kc * (ksplit - 1) < K
        assert ksplit == 1 or kc % 2 == 0
        assert kc <= max(2, block_k + block_k % 2)

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
