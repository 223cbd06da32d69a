#!/usr/bin/env python3
"""Time the port's quantized GeMMs of two or more checkouts on one card, in
turns, at the calls Yi-9B's engine makes:

    python3 tools/gemm_ab.py build/parent build/archive    # from the root

Each checkout (a directory holding ``src/repro_torch``) is measured in its
own process, which imports that checkout's package and builds its kernels
into its own ``build/``; the checkouts run in the order given and then in
reverse (parent, change, change, parent), all on the same card.  The
shapes, the call counts, the timing and the tolerance are this
repository's ``chip_smoke.py``'s (``lm_projections`` of the checkout's
Yi-9B config, ``device_ms``, ``KERNEL_REL_TOL``), so both measure alike.
Per call:

  * ``quant_gemm`` int8 x int8 at every projection shape and the head, at
    the prefill width (M = 128) and at decode (M = 8), with int8
    activations from ``quantize_activation`` and per-column int8 weights;
  * ``quant_gemm`` weight-only at the q projection, M = 128, float32 and
    bfloat16 lhs;
  * ``int4_gemm`` at every projection shape and the head at M = 128,
    float32 and bfloat16 lhs;

each called as the engine calls it (the mapper's 1-byte blocking) and
summed per engine step.  Every result is checked against the checkout's
plain version (int8 exactly, the rest within KERNEL_REL_TOL of max|out|).
Writes ``chiprun_out/gemm_ab.json`` and prints one JSON line per run.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))          # chip_smoke; the package comes from
import chip_smoke as cs  # noqa: E402  the checkout's PYTHONPATH


def measure() -> dict:
    """The timings of the checkout whose ``src`` is on ``sys.path``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.dataflows import GemmShape
    from repro_torch.core.mapper import select_gpu_blocking
    from repro_torch.kernels.quant_gemm import (int4_gemm, int4_gemm_plain,
                                                quant_gemm, quant_gemm_plain)
    from repro_torch.quant.qtensor import (abs_max_scale, pack_int4,
                                           quantize_activation,
                                           quantize_weight)

    cfg = get_config(cs.LM_NAME)
    prefill, decode = cs.LM_SLOTS * cs.LM_CHUNK, cs.LM_SLOTS
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = cs.new_flush()

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def row(kernel, lhs, fn, want, exact, M, K, N, count) -> dict:
        got = fn()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if err > (0.0 if exact
                  else cs.KERNEL_REL_TOL * float(want.abs().max())):
            raise RuntimeError(f"{kernel} {lhs} {(M, K, N)}: the kernel "
                               f"disagrees with its plain version by {err}")
        return {"kernel": kernel, "lhs": lhs, "shape": [M, K, N],
                "per_step": count, "ms": cs.device_ms(fn, flush),
                "max_abs_err": err}

    def block(M, K, N):
        sel = select_gpu_blocking(GemmShape(M, K, N), bytes_per_elem=1)
        return sel.bm, sel.bk, sel.bn

    rows = []
    for (K, N), count in cs.lm_projections(cfg).items():
        qt = quantize_weight(rnd(K, N), fmt="int8")
        for M in (prefill, decode):
            x = rnd(M, K)
            s_act = abs_max_scale(float(x.abs().max())).to(dev)
            a = quantize_activation(x, s_act)
            sc = (s_act * qt.scale).reshape(-1).contiguous()
            blk = block(M, K, N)
            rows.append(row("quant_gemm", "int8",
                            lambda: quant_gemm(a, qt.q, sc, block=blk),
                            quant_gemm_plain(a, qt.q, sc), True,
                            M, K, N, count))
        q4 = torch.randint(-8, 8, (K, N), device=dev, generator=gen,
                           dtype=torch.int8)
        w4 = pack_int4(q4, axis=0).contiguous()
        s4 = torch.rand(N, device=dev, generator=gen) * 1e-2 + 1e-3
        for lhs in (torch.float32, torch.bfloat16):
            a = rnd(prefill, K).to(lhs)
            blk = block(prefill, K, N)
            rows.append(row("int4_gemm", str(lhs)[6:],
                            lambda: int4_gemm(a, w4, s4, k_size=K, block=blk),
                            int4_gemm_plain(a, w4, s4, k_size=K), False,
                            prefill, K, N, count))
        del qt, q4, w4
    K, N = cfg.d_model, cfg.n_heads * cfg.d_head
    qt = quantize_weight(rnd(K, N), fmt="int8")
    sc = qt.scale.reshape(-1).contiguous()
    for lhs in (torch.float32, torch.bfloat16):
        a = rnd(prefill, K).to(lhs)
        blk = block(prefill, K, N)
        rows.append(row("quant_gemm", str(lhs)[6:],
                        lambda: quant_gemm(a, qt.q, sc, block=blk),
                        quant_gemm_plain(a, qt.q, sc), False,
                        prefill, K, N, 0))
    steps: dict = {}
    for r in rows:
        if r["per_step"]:
            key = f"{r['kernel']} {r['lhs']} M={r['shape'][0]}"
            steps[key] = steps.get(key, 0.0) + r["per_step"] * r["ms"]
    return {"rows": rows, "per_step_ms": steps}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in argv]
    if not trees or not all((t / "src" / "repro_torch").is_dir()
                            for t in trees):
        print("usage: gemm_ab.py CHECKOUT [CHECKOUT ...]", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    runs = []
    for tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--measure"],
                             env=env, cwd=tree, capture_output=True,
                             text=True, timeout=1800)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        run = {"tree": os.path.relpath(tree, ROOT), "card": card,
               "per_step_ms": res["per_step_ms"]}
        print(json.dumps(run), flush=True)
        runs.append(dict(run, rows=res["rows"]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gemm_ab.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
