"""Training launcher (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch yi-9b --reduced --device cpu \\
        --steps 100 --batch 8 --seq 64 --ckpt-dir <dir>

Without ``--device`` it trains on the card and raises where there is
none.  It prints the reference's two lines: the model's size and the
run's shape, then the first and last loss and the median step time.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # a backward GeMM of a full-width head under a WS / IS block writes one
    # plane buffer of tens of GiB a step; expandable segments keep the
    # cache from splitting it up between steps (read at CUDA's first
    # allocation, so set before any)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt_cfg = adamw.OptConfig(lr=args.lr,
                              warmup_steps=max(args.steps // 20, 5),
                              total_steps=args.steps)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(cfg, opt_cfg, generator=gen, device=dev,
                             grad_compression=args.grad_compression)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                           grad_compression=args.grad_compression)
    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                              global_batch=args.batch, seed=args.seed,
                              frontend=cfg.frontend, d_model=cfg.d_model,
                              n_patches=cfg.n_patches)
    trainer = Trainer(train_step=step, state=state, dataset=data,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if trainer.maybe_resume():
        print(f"resumed at step {int(trainer.state['step'])}")
    history = trainer.run(args.steps)
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    median = np.median([h["step_time_s"] for h in history]) if history \
        else float("nan")
    print(f"done: loss {first:.4f} -> {last:.4f} over {len(history)} steps; "
          f"median step {median:.3f}s")


if __name__ == "__main__":
    main()
