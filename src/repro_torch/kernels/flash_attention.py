"""Int8 flash attention: the CUDA kernel, its plain version and the
per-head quantizer that feeds both.

Port of ``repro.kernels.flash_attention.int8_flash_attention_fwd`` (and its
``_per_head_quantize``).  Q, K and V are quantized per head, symmetric
int8 with ``scale = amax over (B, S, dh) / 127`` -- over every slot of the
batch, as the reference does -- in plain PyTorch before the launch, as the
reference quantizes outside its ``pallas_call``.  The kernel
(``csrc/int8_flash_attention.cu``) then walks the kv blocks in order with
int32 QK^T and PV and a float online softmax whose probabilities are
requantized to int8 per block.  Because that requantization is taken
against the running max at each block, the block sizes are part of the
function: :func:`int8_flash_attention_plain` repeats the reference's
blockwise loop (never a one-shot softmax), and the kernel walks the same
blocks.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, check_operands, on_cpu

_NEG_INF = -1e30
_EPS = 1e-9
MAX_TILE = 128       # the kernel's largest bq, bkv and dh


def _per_head_quantize(x: torch.Tensor, qmax: float = 127.0):
    """(B, H, S, dh) float -> (int8 payload, (H, 1) float32 per-head
    scale); ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=(0, 2, 3))
    scale = torch.clamp(amax, min=_EPS) / qmax                  # (H,)
    xq = torch.clamp(torch.round(xf / scale[None, :, None, None]),
                     -qmax, qmax).to(torch.int8)
    return xq, scale[:, None]


def _prepare(q, k, v, mask, causal, scale):
    """The quantized operands, the combined scales and the explicit mask."""
    B, H, Sq, dh = q.shape
    KvH, Skv = k.shape[1], k.shape[2]
    if H % KvH or v.shape[:3] != k.shape[:3] or k.shape[0] != B:
        raise ValueError(f"int8_flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    rep = H // KvH
    sm_scale = dh ** -0.5 if scale is None else scale
    # the kernel takes contiguous payloads; elementwise ops keep a
    # transposed input's strides, so the layers' (B, T, H, dh) -> (B, H,
    # T, dh) views come out transposed
    qq, sq = _per_head_quantize(q)
    kq, sk = _per_head_quantize(k)
    vq, sv = _per_head_quantize(v)
    qq, kq, vq = qq.contiguous(), kq.contiguous(), vq.contiguous()
    head_group = torch.arange(H, device=q.device) // rep
    sqk = (sq * sk[head_group] * sm_scale).reshape(H)
    if mask is None:
        q_idx = torch.arange(Sq, device=q.device)
        kv_idx = torch.arange(Skv, device=q.device)
        m2 = kv_idx[None, :] <= q_idx[:, None] if causal \
            else torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        mask = m2[None].expand(B, Sq, Skv)
    if tuple(mask.shape) != (B, Sq, Skv) or mask.dtype != torch.bool:
        raise ValueError(f"int8_flash_attention: mask {tuple(mask.shape)} "
                         f"{mask.dtype}, expected ({B}, {Sq}, {Skv}) bool")
    return qq, kq, vq, mask.contiguous(), sqk, sv.reshape(KvH)


def _blocks(Sq: int, Skv: int, block_q: int, block_kv: int) -> tuple[int, int]:
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"int8_flash_attention: blocks ({block_q}, "
                         f"{block_kv}) must be >= 1")
    return min(block_q, Sq), min(block_kv, Skv)


def int8_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, mask=None,
                               causal: bool = True, scale=None,
                               block_q: int = 128,
                               block_kv: int = 128) -> torch.Tensor:
    """The same function in plain PyTorch: the reference kernel's loop over
    zero-padded kv blocks of ``min(block_kv, Skv)`` rows, in order, for
    all query rows at once (rows are independent, so ``block_q`` only
    pads).  Integer products in float64 (exact); every statistic in
    float32 with the reference's operations in its order."""
    B, H, Sq, dh = q.shape
    KvH, Skv = k.shape[1], k.shape[2]
    rep = H // KvH
    bq, bkv = _blocks(Sq, Skv, block_q, block_kv)
    qq, kq, vq, mask, sqk, sv = _prepare(q, k, v, mask, causal, scale)
    q_pad, kv_pad = (-Sq) % bq, (-Skv) % bkv
    qf = F.pad(qq.double(), (0, 0, 0, q_pad))
    kf = F.pad(kq.double(), (0, 0, 0, kv_pad)).repeat_interleave(rep, dim=1)
    vf = F.pad(vq.double(), (0, 0, 0, kv_pad)).repeat_interleave(rep, dim=1)
    maskp = F.pad(mask, (0, kv_pad, 0, q_pad))[:, None]   # (B, 1, Sqp, Skvp)
    s_qk = sqk[None, :, None, None]
    s_v = (sv / 127.0).repeat_interleave(rep)[None, :, None, None]
    Sqp = Sq + q_pad
    m = torch.full((B, H, Sqp, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sqp, dh), dtype=torch.float32, device=q.device)
    for kv0 in range(0, Skv + kv_pad, bkv):
        kj, vj = kf[:, :, kv0:kv0 + bkv], vf[:, :, kv0:kv0 + bkv]
        s = torch.matmul(qf, kj.transpose(-1, -2)).float() * s_qk
        s = torch.where(maskp[..., kv0:kv0 + bkv], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        pq = torch.round(p * 127.0)
        corr = torch.exp(m - m_new)
        l = l * corr + pq.sum(dim=-1, keepdim=True) / 127.0
        pv = torch.matmul(pq.double(), vj).float()
        acc = acc * corr + pv * s_v
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out[:, :, :Sq].to(q.dtype)


def _entry():
    fn = _build.load("int8_flash_attention").int8_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, mask=None,
                             causal: bool = True, scale=None,
                             block_q: int = 128,
                             block_kv: int = 128) -> torch.Tensor:
    """Int8-operand attention with float softmax statistics.

    ``q (B, H, Sq, dh)``, ``k`` / ``v (B, KvH, Skv, dh)`` float; ``mask
    (B, Sq, Skv)`` bool replaces the causal mask when given; ``scale``
    None means ``dh ** -0.5``.  Returns ``(B, H, Sq, dh)`` in q's dtype.
    The kernel takes ``dh % 4 == 0``, ``dh <= 128`` and blocks of at most
    128 rows."""
    B, H, Sq, dh = q.shape
    KvH, Skv = k.shape[1], k.shape[2]
    if on_cpu(q, k, v) and (mask is None or on_cpu(mask)):
        return int8_flash_attention_plain(
            q, k, v, mask=mask, causal=causal, scale=scale, block_q=block_q,
            block_kv=block_kv)
    bq, bkv = _blocks(Sq, Skv, block_q, block_kv)
    if dh % 4 or dh > MAX_TILE or bq > MAX_TILE or bkv > MAX_TILE:
        raise ValueError(f"int8_flash_attention: dh {dh} (a multiple of 4, "
                         f"<= {MAX_TILE}) and blocks ({bq}, {bkv}) (<= "
                         f"{MAX_TILE}) outside the kernel's range")
    qq, kq, vq, mask, sqk, sv = _prepare(q, k, v, mask, causal, scale)
    dev = check_operands("int8_flash_attention", qq, kq, vq, mask, sqk, sv,
                         dtypes=(torch.int8,) * 3 + (torch.bool,)
                         + (torch.float32,) * 2)
    out = torch.empty((B, H, Sq, dh), dtype=torch.float32, device=dev)
    status = _entry()(
        qq.data_ptr(), kq.data_ptr(), vq.data_ptr(), mask.data_ptr(),
        sqk.data_ptr(), sv.data_ptr(), out.data_ptr(), B, H, KvH, Sq, Skv,
        dh, bq, bkv, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "int8_flash_attention")
    int8_flash_attention_fwd.launches += 1
    return out.to(q.dtype)


int8_flash_attention_fwd.launches = 0
