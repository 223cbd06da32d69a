#!/usr/bin/env python3
"""Where the int8 attention kernel parts from its plain version, call by
call, at the calls ``chip_smoke.py`` checks it at:

    python3 tools/int8_attention_diff.py        # from the root, one card

The calls: Yi-9B (32 heads, 4 KV heads, dh 128), Mixtral-8x7B's wrapped
4096-token window at decode (32 / 8, dh 128), Zamba2-7B's shared block
(32 / 32, dh 112) and InternVL2-1B (14 / 2, dh 64), the others at decode
and at the prefill width (16 tokens a slot), on 8 slots: q float32, the
bfloat16 cache, the engine's mask (``chip_smoke.lm_engine_mask``, the
Mixtral window's as ``chip_smoke`` builds it), random values from the
seed.  Each call goes through ``int8_flash_attention_fwd`` (the card's two
launches) and is compared with

  * ``plain``: ``int8_flash_attention_plain`` as it stands;
  * ``reciprocal``: the same function with every division by a constant
    (the per-head scale's ``/ 127``, ``sv / 127``, the row sums of p
    ``/ 127``) taken as PyTorch takes ``x / 127.0`` on a CUDA tensor: a
    multiply by float32(1 / 127).

Per call: the error of each against the kernel (relative to max|out|),
whether the kernel's per-head amax equals the plain version's, the heads
whose scale differs between the two divisions and the int8 values that
differ.  Where the kernel and ``plain`` still part (an output row off by
more than ROW_TOL of max|out|), each such row's p entries that lie within
BOUNDARY_ULPS of a rounding boundary of ``round(p * 127)`` (half way
between two integers) are listed, and the row is recomputed with each of
them rounded the other way: the row counts as explained when one such
turn gives the kernel's row within ROW_TOL.  One JSON line a call on
standard output, a summary line last; exit 1 when a row is unexplained.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.append(str(ROOT))
import chip_smoke as cs  # noqa: E402

ROW_TOL = 1e-6          # of max|out|: an output row the kernel's
BOUNDARY_ULPS = 4       # p * 127 this close to k + 1/2 may round either way
MAX_ROWS = 32           # differing rows examined a call


def divide(x, c: float, exact: bool):
    """``x / c`` correctly rounded, or as PyTorch divides a CUDA tensor by
    a Python number: times float32(1 / c)."""
    from repro_torch.kernels.flash_attention import _div
    return _div(x, c) if exact else x * _div(x.new_ones(()), c)


def quantize(x, exact: bool):
    """``_per_head_quantize`` with the scale's division exact or by the
    rounded reciprocal."""
    import torch
    from repro_torch.kernels.flash_attention import _EPS
    xf = x.float()
    amax = xf.abs().amax(dim=(0, 2, 3))
    scale = divide(torch.clamp(amax, min=_EPS), 127.0, exact)
    xq = torch.clamp(torch.round(xf / scale[None, :, None, None]),
                     -127, 127).to(torch.int8)
    return xq, scale, amax


def attention(q, k, v, mask, bkv: int, exact: bool, flips=None,
              boundary=None):
    """The plain version's blockwise loop (``int8_flash_attention_plain``),
    the divisions by constants ``exact`` or not.  ``flips``: {(b, h, t, kv):
    +1 or -1} added to those pq entries.  ``boundary`` (a list): gets (b,
    h, t, kv, p * 127, distance to k + 1/2 in ulps) of every entry within
    BOUNDARY_ULPS of a rounding boundary."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import _NEG_INF

    B, H, Sq, dh = q.shape
    KvH, Skv = k.shape[1], k.shape[2]
    rep = H // KvH
    qq, sq, _ = quantize(q, exact)
    kq, sk, _ = quantize(k, exact)
    vq, sv, _ = quantize(v, exact)
    group = torch.arange(H, device=q.device) // rep
    s_qk = (sq * sk[group] * dh ** -0.5)[None, :, None, None]
    s_v = divide(sv, 127.0, exact).repeat_interleave(rep)
    s_v = s_v[None, :, None, None]
    pad = (-Skv) % bkv
    qf = qq.double()
    kf = F.pad(kq.double(), (0, 0, 0, pad)).repeat_interleave(rep, dim=1)
    vf = F.pad(vq.double(), (0, 0, 0, pad)).repeat_interleave(rep, dim=1)
    maskp = F.pad(mask, (0, pad))[:, None]
    m = torch.full((B, H, Sq, 1), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, dh), device=q.device)
    for kv0 in range(0, Skv + pad, bkv):
        s = torch.matmul(qf, kf[:, :, kv0:kv0 + bkv].transpose(-1, -2))
        s = torch.where(maskp[..., kv0:kv0 + bkv], s.float() * s_qk,
                        _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        x = torch.exp(s - m_new) * 127.0
        pq = torch.round(x)
        if boundary is not None:
            ulp = torch.nextafter(x, torch.full_like(x, float("inf"))) - x
            dist = ((x - torch.floor(x)) - 0.5).abs() / ulp
            for b, h, t, c in torch.nonzero(dist <= BOUNDARY_ULPS).tolist():
                boundary.append((b, h, t, kv0 + c, float(x[b, h, t, c]),
                                 float(dist[b, h, t, c])))
        for (b, h, t, kv), d in (flips or {}).items():
            if kv0 <= kv < kv0 + bkv:
                pq[b, h, t, kv - kv0] += d
        corr = torch.exp(m - m_new)
        l = l * corr + divide(pq.sum(dim=-1, keepdim=True), 127.0, exact)
        pv = torch.matmul(pq.double(), vf[:, :, kv0:kv0 + bkv]).float()
        acc = acc * corr + pv * s_v
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def calls(dev, gen) -> list:
    """[(name, q, k, v, mask)] as chip_smoke's checks make them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    out = []
    B, S_ = cs.LM_SLOTS, cs.LM_MAX_LEN
    for name in (cs.LM_NAME, cs.ZB_NAME, cs.VL_NAME):
        cfg = get_config(name)
        H, KvH, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
        for T in (1, cs.LM_CHUNK):
            q = torch.randn(B, H, T, dh, device=dev, generator=gen)
            k, v = (torch.randn(B, KvH, S_ + T, dh, device=dev,
                                generator=gen).bfloat16() for _ in range(2))
            out.append((f"{name} T={T}", q, k, v,
                        cs.lm_engine_mask(T, S_, dev)))
    cfg = get_config(cs.MIX_NAME)
    H, KvH, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    window = cfg.stages[0].window
    start = torch.tensor(cs.MIX_WINDOW_LENS, device=dev)
    ok_old, ok_new, live = L.cache_masks(
        start, start[:, None] + torch.arange(1, device=dev),
        torch.ones((B, 1), dtype=torch.bool, device=dev), window, window)
    q = torch.randn(B, H, 1, dh, device=dev, generator=gen)
    k, v = (torch.randn(B, KvH, window + 1, dh, device=dev,
                        generator=gen).bfloat16() for _ in range(2))
    dead = torch.cat([~live, torch.zeros((B, 1), dtype=torch.bool,
                                         device=dev)], dim=1)
    for t in (k, v):
        t.masked_fill_(dead[:, None, :, None], 0)
    out.append((f"{cs.MIX_NAME} window T=1", q, k, v,
                torch.cat([ok_old, ok_new], dim=-1)))
    return out


def main() -> int:
    import torch
    from repro_torch.kernels import flash_attention as tfa

    if not torch.cuda.is_available():
        print("int8_attention_diff: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    unexplained = 0
    summary = []
    for name, q, k, v, mask in calls(dev, gen):
        Skv = k.shape[2]
        bkv = min(128, Skv)
        kw = dict(mask=mask, block_q=min(128, q.shape[2]), block_kv=bkv)
        got = tfa.int8_flash_attention_fwd(q, k, v, **kw)
        plain = tfa.int8_flash_attention_plain(q, k, v, **kw)
        recip = attention(q, k, v, mask, bkv, exact=False)
        mine = attention(q, k, v, mask, bkv, exact=True)
        scale = float(plain.abs().max())
        amax_q, amax_k, amax_v = tfa.head_amax(q, k, v)
        row = {"call": name, "q": list(q.shape), "kv": list(k.shape),
               "max_rel_err": {
                   "plain": float((got - plain).abs().max()) / scale,
                   "reciprocal": float((got - recip).abs().max()) / scale},
               "loop_equals_plain": bool(torch.equal(mine, plain)),
               "amax_equal": all(
                   bool(torch.equal(a, quantize(x, True)[2]))
                   for a, x in ((amax_q, q), (amax_k, k), (amax_v, v)))}
        heads, values = {}, {}
        for what, x in (("q", q), ("k", k), ("v", v)):
            xe, se, _ = quantize(x, True)
            xr, sr, _ = quantize(x, False)
            heads[what] = [int(h) for h in torch.nonzero(se != sr)
                           .flatten()]
            values[what] = int((xe != xr).sum())
        row.update(reciprocal_scale_heads=heads,
                   reciprocal_int8_values_differ=values)
        # the rows where the kernel and the plain version still part
        d = (got - plain).abs().amax(dim=-1) / scale        # (B, H, Sq)
        rows = [tuple(r) for r in torch.nonzero(d > ROW_TOL).tolist()]
        boundary: list = []
        attention(q, k, v, mask, bkv, exact=True, boundary=boundary)
        by_row: dict = {}
        for b, h, t, kv, x, dist in boundary:
            by_row.setdefault((b, h, t), []).append((kv, x, dist))
        examined = []
        for b, h, t in rows[:MAX_ROWS]:
            cands = by_row.get((b, h, t), [])
            best = None
            for kv, x, dist in cands:
                turn = -1.0 if round(x) > x else 1.0
                alt = attention(q, k, v, mask, bkv, exact=True,
                                flips={(b, h, t, kv): turn})
                e = float((got[b, h, t] - alt[b, h, t]).abs().max()) / scale
                if best is None or e < best[1]:
                    best = ((kv, x, dist, turn), e)
            ok = best is not None and best[1] <= ROW_TOL
            unexplained += not ok
            examined.append({
                "row": [b, h, t], "rel_err": float(d[b, h, t]),
                "boundary_entries": [[kv, x, dist] for kv, x, dist in cands],
                "turned": None if best is None else list(best[0]),
                "rel_err_turned": None if best is None else best[1],
                "explained": ok})
        unexplained += max(0, len(rows) - MAX_ROWS)
        row.update(rows_differ=len(rows), boundary_entries=len(boundary),
                   rows=examined)
        print(json.dumps(row), flush=True)
        summary.append({"call": name, "rows_differ": len(rows),
                        "plain": row["max_rel_err"]["plain"],
                        "reciprocal": row["max_rel_err"]["reciprocal"]})
    print(json.dumps({"summary": summary, "unexplained_rows": unexplained}))
    return 1 if unexplained else 0


if __name__ == "__main__":
    sys.exit(main())
