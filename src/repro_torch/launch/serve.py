"""Serving launcher (port of ``repro.launch.serve``): continuous-batching
(or wave-batched) generation demo.

    python -m repro_torch.launch.serve --arch yi-9b --requests 8 \\
        --trace-out trace.json --metrics-out metrics.json

Without ``--device`` it serves on the card and raises where there is none.
As in the reference, ``--reduced`` is on by default (and cannot be turned
off): the launcher serves the reduced config, its weights from a seeded
``torch.Generator``.  The telemetry flags (``--trace-out``,
``--metrics-out``, ``--prom-out``, ``--profile-dir``, ``--stream-dir``,
``--sample-every``) turn ``repro_torch.obs`` on and write its artifacts;
``--profile-dir`` exports a ``torch.profiler`` Chrome trace there.
``--mesh`` and ``--fake-devices`` raise: sharding is not ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (
    QUEUE_POLICIES,
    Request,
    ServeEngine,
    WaveServeEngine,
)

NOT_PORTED_MESH = "not ported yet: sharding (ROADMAP Queue 1 item 5)"


def build_requests(cfg, n: int, prompt_len: int, max_new: int, *,
                   mixed: bool = False) -> list[Request]:
    """``n`` requests of ``prompt_len`` random tokens (every other one 3x
    as long with ``mixed``), drawn from a ``torch.Generator`` seeded 1."""
    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(n):
        plen = prompt_len * (3 if mixed and i % 2 else 1)
        prompt = torch.randint(2, cfg.vocab, (plen,), generator=gen)
        reqs.append(Request(prompt=prompt.tolist(), max_new_tokens=max_new))
    return reqs


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="yi-9b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--engine", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--mixed", action="store_true",
                    help="alternate short/3x-long prompts (shows the "
                         "head-of-line win of continuous batching)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--queue-policy", choices=QUEUE_POLICIES, default="fifo")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="shard the engine over a device mesh (not ported "
                         "yet: raises)")
    ap.add_argument("--decouple-prefill", action="store_true",
                    help="run prompts through a dedicated prefill step and "
                         "hand the cache to a decode slot via the insert "
                         "step (dense caches only)")
    ap.add_argument("--fake-devices", type=int, default=None,
                    help="fake N host devices for --mesh (not ported yet: "
                         "raises)")
    ap.add_argument("--trace-out", default=None,
                    help="enable repro_torch.obs and write a Chrome-trace "
                         "JSON (load at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None,
                    help="enable repro_torch.obs and write a metrics "
                         "snapshot")
    ap.add_argument("--prom-out", default=None,
                    help="enable repro_torch.obs and write the Prometheus "
                         "text exposition")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace into this "
                         "directory (model scopes nest under serve steps "
                         "in eager steps)")
    ap.add_argument("--sample-every", type=int, default=1,
                    help="op-ring sampling stride (counters stay exact)")
    ap.add_argument("--stream-dir", default=None,
                    help="stream periodic metric snapshots (JSONL + prom "
                         "textfile) into this directory during the serve")
    ap.add_argument("--stream-interval", type=float, default=None,
                    help="seconds between streaming snapshots")
    args = ap.parse_args(argv)
    if args.mesh is not None or args.fake_devices is not None:
        raise NotImplementedError(NOT_PORTED_MESH)

    dev = resolve_device(args.device)
    obs_on = bool(args.trace_out or args.metrics_out or args.prom_out
                  or args.stream_dir or args.profile_dir
                  or args.sample_every > 1)
    if obs_on:
        import repro_torch.obs as obs
        from repro_torch.obs import profiler, streaming
        obs.enable()
        obs.configure(sample_every=args.sample_every)
        if args.profile_dir:
            profiler.start(args.profile_dir)
        if args.stream_dir:
            interval = args.stream_interval \
                if args.stream_interval is not None \
                else streaming.DEFAULT_INTERVAL_S
            streaming.start(args.stream_dir, interval_s=interval)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = T.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    slots = min(args.batch_slots, args.requests)
    max_prompt = args.prompt_len * (3 if args.mixed else 1)
    max_len = max_prompt + args.max_new + 1
    reqs = build_requests(cfg, args.requests, args.prompt_len, args.max_new,
                          mixed=args.mixed)

    if args.engine == "wave":
        engine = WaveServeEngine(model, cfg, batch_slots=slots,
                                 max_len=max_len,
                                 temperature=args.temperature, device=dev)
    else:
        engine = ServeEngine(model, cfg, batch_slots=slots, max_len=max_len,
                             prefill_chunk=args.prefill_chunk,
                             queue_policy=args.queue_policy,
                             temperature=args.temperature,
                             decouple_prefill=args.decouple_prefill,
                             device=dev)
    outs = engine.generate(reqs)
    for i, o in enumerate(outs):
        print(f"req{i} ({len(reqs[i].prompt)}-token prompt): {o}")
    stats = getattr(engine, "last_stats", None)
    if stats:
        lat = [r["latency_s"] for r in stats["requests"]]
        print(f"{stats['generated_tokens']} tokens in "
              f"{stats['wall_s']:.2f}s ({stats['tokens_per_s']:.1f} tok/s, "
              f"{stats['steps']} steps, p50 latency "
              f"{np.percentile(lat, 50):.2f}s, "
              f"p99 {np.percentile(lat, 99):.2f}s)")

    if stats and "attribution" in stats:
        att = stats["attribution"]
        print(f"attribution: modeled {att['modeled_flops']:.3g} FLOPs, "
              f"step coverage {att['modeled_step_coverage']:.0%}, "
              f"roofline {att['roofline']}")

    if obs_on:
        if args.profile_dir and profiler.stop():
            print(f"profiler trace in {args.profile_dir}")
        if args.stream_dir:
            streaming.stop()
            print(f"streamed snapshots in {args.stream_dir}")
        if args.trace_out:
            obs.write_chrome_trace(args.trace_out, process_name="serve")
            print(f"trace written to {args.trace_out}")
        if args.metrics_out:
            obs.REGISTRY.write_json(args.metrics_out)
            print(f"metrics written to {args.metrics_out}")
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(obs.metrics.prometheus_text())
            print(f"prometheus exposition written to {args.prom_out}")


if __name__ == "__main__":
    main()
