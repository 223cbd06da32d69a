"""The port's float ``flash_attention_fwd`` against the JAX reference, on the
grid of ``tests/test_flash_kernel.py``: MHA; GQA with a ragged sequence;
MQA with ragged blocks; causal and not; float32 and bfloat16.

Inputs come from numpy seeds and go to both packages; the reference runs
its Pallas kernel in interpret mode, the port the kernel's plain version on
CPU tensors.  Tolerances, each with its reason:

  * float32: rtol / atol 2e-5 (``_torch_parity.assert_close``) -- f32 in
    another summation order.
  * bfloat16: 1e-2 * max|out|, absolute -- p is rounded to bfloat16 before
    PV and the output is bfloat16, so an ulp of ``exp`` or of a sum can
    move a value by one bfloat16 step (2^-8 relative) at either rounding.

The ``cuda``-marked tests hold the CUDA kernel against its plain version
on the card (the same tolerances) and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, cuda_device, jax_alias,  # noqa: F401
                           np_of, rand, to_jax, to_torch)
from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as L

pytestmark = pytest.mark.usefixtures("jax_alias")

BF16_TOL = 1e-2

GRID = [(1, 4, 4, 64, 16, 16, 16),     # MHA
        (2, 8, 2, 48, 8, 16, 16),      # GQA rep=4, ragged seq
        (1, 4, 1, 33, 16, 8, 16)]      # MQA, ragged both blocks
GRID_IDS = ["mha", "gqa_ragged", "mqa_ragged_blocks"]


def _qkv(seed, b, h, kvh, s, dh, skv=None):
    skv = s if skv is None else skv
    return (rand(seed, b, h, s, dh), rand(seed + 1, b, kvh, skv, dh),
            rand(seed + 2, b, kvh, skv, dh))


def _close(got, want, dtype):
    if dtype == "float32":
        assert_close(got, want)
        return
    got = np_of(got.float()) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,s,dh,bq,bkv", GRID, ids=GRID_IDS)
def test_matches_reference(causal, dtype, b, h, kvh, s, dh, bq, bkv):
    q, k, v = _qkv(b * h + s, b, h, kvh, s, dh)
    jq, jk, jv = (to_jax(x).astype(dtype) for x in (q, k, v))
    tq, tk, tv = (to_torch(x).to(getattr(torch, dtype)) for x in (q, k, v))
    want = jfa.flash_attention_fwd(jq, jk, jv, causal=causal, block_q=bq,
                                   block_kv=bkv, interpret=True)
    got = tfa.flash_attention_fwd(tq, tk, tv, causal=causal, block_q=bq,
                                  block_kv=bkv)
    assert got.shape == (b, h, s, dh) and got.dtype == tq.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("sq,skv", [(5, 19), (19, 5)])
def test_unequal_lengths_match_reference(sq, skv):
    # top-left aligned causal mask: k_idx <= q_idx with no offset
    q, k, v = _qkv(3, 2, 4, 2, sq, 8, skv)
    want = jfa.flash_attention_fwd(to_jax(q), to_jax(k), to_jax(v),
                                   block_q=4, block_kv=8, interpret=True)
    got = tfa.flash_attention_fwd(to_torch(q), to_torch(k), to_torch(v),
                                  block_q=4, block_kv=8)
    assert_close(got, want)


def test_matches_model_level_attention():
    # kernel (B, H, S, dh) layout vs the layers' blocked (B, S, H, dh) one
    q, k, v = _qkv(9, 2, 4, 2, 32, 16)
    tq, tk, tv = (to_torch(x) for x in (q, k, v))
    want = L.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2), causal=True, block_q=8,
                             block_kv=8)
    got = tfa.flash_attention_fwd(tq, tk, tv, causal=True, block_q=8,
                                  block_kv=8)
    assert_close(got.transpose(1, 2), want)


def test_bf16_probabilities_follow_the_blocks():
    # p is rounded to bfloat16 against each block's running max, so the
    # kv block size is part of the bfloat16 function
    q, k, v = (to_torch(x).bfloat16() for x in _qkv(4, 1, 2, 1, 8, 16, 64))
    a = tfa.flash_attention_plain(4 * q, k, v, causal=False, block_kv=8)
    b = tfa.flash_attention_plain(4 * q, k, v, causal=False, block_kv=64)
    assert not torch.equal(a, b)


def test_rejects_bad_shapes():
    q, k, v = (to_torch(x) for x in _qkv(1, 1, 3, 2, 4, 8))
    with pytest.raises(ValueError, match="flash_attention"):
        tfa.flash_attention_fwd(q, k, v)


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,h,kvh,s,dh,bq,bkv",
                             GRID + [(2, 32, 4, 300, 128, 128, 128)],
                             ids=GRID_IDS + ["yi_heads"])
    def test_kernel_matches_plain(self, cuda_device, causal, dtype, b, h,
                                  kvh, s, dh, bq, bkv):
        g = torch.Generator(device=cuda_device).manual_seed(s)
        q, k, v = (torch.randn(b, n, s, dh, generator=g, device=cuda_device
                               ).to(getattr(torch, dtype))
                   for n in (h, kvh, kvh))
        got = tfa.flash_attention_fwd(q, k, v, causal=causal, block_q=bq,
                                      block_kv=bkv)
        want = tfa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                         block_kv=bkv)
        tol = 1e-4 if dtype == "float32" else BF16_TOL
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * float(want.float().abs().max())
