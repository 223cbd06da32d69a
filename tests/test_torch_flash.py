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

The kernel skips, with a causal mask, the kv blocks masked for every row
of a q tile (``flash_tile_blocks``); a model of that walk on the CPU
drops those blocks from the plain loop and must leave every row EQUAL, bit
for bit (finite operands: p = 0 and corr = 1 there exactly).

The ``cuda``-marked tests hold the CUDA kernel against its plain version
on the card (the same tolerances; float32 1e-4 * max|out|, the six-product
split and another order) and skip here.
"""
import torch.nn.functional as F
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


def _plain_skipping(q, k, v, *, bkv, rows):
    """``flash_attention_plain``'s causal loop with the kernel's walk: the
    rows of q tile i (``rows`` each) take only the first
    ``flash_tile_blocks(...)[i]`` kv blocks; the rest leave them as they
    are."""
    B, H, Sq, dh = q.shape
    KvH, Skv = k.shape[1], k.shape[2]
    rep = H // KvH
    bkv = min(bkv, Skv)
    kv_pad = (-Skv) % bkv
    counts = tfa.flash_tile_blocks(Sq, Skv, bkv, rows, True)
    row_blocks = torch.tensor(counts).repeat_interleave(rows)[:Sq]
    qf = q.float()
    kf = F.pad(k.float(), (0, 0, 0, kv_pad)).repeat_interleave(rep, dim=1)
    vp = F.pad(v, (0, 0, 0, kv_pad)).repeat_interleave(rep, dim=1)
    q_idx = torch.arange(Sq)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, dh))
    for j, kv0 in enumerate(range(0, Skv + kv_pad, bkv)):
        s = torch.matmul(qf, kf[:, :, kv0:kv0 + bkv].transpose(-1, -2)) \
            * dh ** -0.5
        k_idx = kv0 + torch.arange(bkv)
        live = (k_idx < Skv)[None, :] & (k_idx[None, :] <= q_idx[:, None])
        s = torch.where(live, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(
            p.to(v.dtype).float(), vp[:, :, kv0:kv0 + bkv].float())
        take = (j < row_blocks)[:, None]
        m = torch.where(take, m_new, m)
        l = torch.where(take, l_new, l)
        acc = torch.where(take, acc_new, acc)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("rows", [16, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,s,dh,bq,bkv", GRID + [
    (1, 2, 1, 300, 16, 128, 48)], ids=GRID_IDS + ["long_ragged"])
def test_skipped_blocks_leave_rows_unchanged(rows, dtype, b, h, kvh, s, dh,
                                             bq, bkv):
    # the kernel's tile heights (64 bf16, 128 float32) and a warp's 16
    q, k, v = (to_torch(x).to(getattr(torch, dtype))
               for x in _qkv(b * h + s + rows, b, h, kvh, s, dh))
    want = tfa.flash_attention_plain(q, k, v, causal=True, block_q=bq,
                                     block_kv=bkv)
    got = _plain_skipping(q, k, v, bkv=bkv, rows=rows)
    assert torch.equal(got, want)


def test_tile_blocks_skip_the_masked_blocks():
    # FLASH_SHAPE's 512 tokens in 128-row blocks: the 128-row tiles of a
    # float32 call compute 1 + 2 + 3 + 4 blocks of 16; the 64-row tiles
    # of a bfloat16 call 2 * (1 + 2 + 3 + 4) of 32
    assert tfa.flash_tile_blocks(512, 512, 128, 128, True) == [1, 2, 3, 4]
    assert tfa.flash_tile_blocks(512, 512, 128, 64, True) == \
        [1, 1, 2, 2, 3, 3, 4, 4]
    assert tfa.flash_tile_blocks(512, 512, 128, 128, False) == [4] * 4
    # Sq != Skv: the last tile's last live row bounds it
    assert tfa.flash_tile_blocks(5, 19, 8, 128, True) == [1]
    assert tfa.flash_tile_blocks(19, 5, 8, 16, True) == [1, 1]
    assert tfa.FLASH_ROWS == {torch.float32: 128, torch.bfloat16: 64}


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

    # the shapes the tensor-core tiles make hard: dh padded to 16 (8, 72),
    # kv blocks not a multiple of the 32-column score group (16, 48) or of
    # the 16-column PV step (40), Sq != Skv both ways, ragged tiles
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("dh", [8, 72, 128])
    @pytest.mark.parametrize("bkv", [16, 40, 48, 128])
    @pytest.mark.parametrize("sq,skv", [(200, 200), (70, 300), (300, 70)])
    def test_padded_heads_and_blocks(self, cuda_device, causal, dtype, dh,
                                     bkv, sq, skv):
        g = torch.Generator(device=cuda_device).manual_seed(dh + bkv + sq)
        dt = getattr(torch, dtype)
        q = torch.randn(2, 8, sq, dh, generator=g, device=cuda_device).to(dt)
        k, v = (torch.randn(2, 2, skv, dh, generator=g, device=cuda_device)
                .to(dt) for _ in range(2))
        n0 = tfa.flash_attention_fwd.launches
        got = tfa.flash_attention_fwd(q, k, v, causal=causal, block_q=64,
                                      block_kv=bkv)
        assert tfa.flash_attention_fwd.launches == n0 + 1
        assert got.dtype == dt and got.shape == q.shape
        want = tfa.flash_attention_plain(q, k, v, causal=causal, block_q=64,
                                         block_kv=bkv)
        tol = 1e-4 if dtype == "float32" else BF16_TOL
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * float(want.float().abs().max())

    def test_unaligned_rows_take_element_loads(self, cuda_device):
        # dh 36 bf16 (72 bytes a row) and an operand off 16 bytes
        q = torch.randn(1, 4, 50, 36, device=cuda_device).bfloat16()
        buf = torch.randn(2 * 90 * 36 + 1, device=cuda_device)
        k = buf[1:].view(1, 2, 90, 36)
        v = torch.randn(1, 2, 90, 36, device=cuda_device)
        got = tfa.flash_attention_fwd(q.float(), k, v, block_kv=32)
        want = tfa.flash_attention_plain(q.float(), k, v, block_kv=32)
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
        kb, vb = k.bfloat16(), v.bfloat16()
        got = tfa.flash_attention_fwd(q, kb, vb, block_kv=32)
        want = tfa.flash_attention_plain(q, kb, vb, block_kv=32)
        assert float((got.float() - want.float()).abs().max()) <= \
            BF16_TOL * float(want.float().abs().max())
