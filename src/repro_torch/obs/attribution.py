"""Measured-vs-modeled attribution: join the op ring against wall scopes
(port of ``repro.obs.attribution``).

The op ring records the *modeled* side of every eager dispatch (FLOPs =
2*B*M*K*N, HBM operand traffic from the Fig. 11 model under the port's
own blocking, DRAM energy); with ``optrace.configure(measure_dispatch=
True)`` the dispatcher also times each eager kernel call, synchronizing
its CUDA device, and records a ``dispatch:<kind>`` wall scope -- the
*measured* side.  This module joins the two per kernel kind per backend
and reports:

  * achieved FLOP/s and achieved bytes/s (modeled volume / measured wall);
  * roofline placement against a :class:`~repro_torch.core.hw.ChipSpec`;
  * modeled-vs-measured time error (``measured_wall_s / modeled_time_s``)
    and its inverse, the roofline share of the measured wall.

The chip is the card's (``hw.current_chip()``) by default, and must be
passed on the CPU (``hw.H100_SXM``: the card the port is modeled for).
Where the reference has one peak, the port times each dispatch's FLOPs at
the H100's dense rate of its operands' precision, the rule of the bounds
in ``PERF.md``: float32 / bfloat16 / float16 at ``peak_bf16_flops`` (the
least time any tensor-core path could take), int8 at ``peak_int8_ops``,
fp8 at ``peak_fp8_flops``.  Roofline time = max(compute time, bytes /
``hbm_bw``).

Captured steps never hit the ring (a replay runs no Python), so their
modeled cost arrives via the traced ledger that ``StepGraphs`` keeps per
captured key; eager steps are costed from the host ledger.  The serve and
vision engines sum those per step and surface an aggregate
achieved-intensity row in ``last_stats`` (see :func:`engine_row`).
"""
from __future__ import annotations

import json
from typing import Any

from repro_torch.core import hw
from repro_torch.core.hw import ChipSpec
from repro_torch.obs import optrace

# wall scopes recorded by the dispatcher under measure_dispatch
WALL_PREFIX = "dispatch:"


def _chip(chip: ChipSpec | None) -> ChipSpec:
    return hw.current_chip() if chip is None else chip


def modeled_chip(device) -> ChipSpec:
    """The chip an engine's attribution row is modeled for: the card's,
    or the H100 SXM the port targets when it serves on the CPU."""
    return hw.current_chip() if device.type == "cuda" else hw.H100_SXM


def _chip_info(chip: ChipSpec) -> dict[str, Any]:
    return {"name": chip.name, "peak_flops": chip.peak_bf16_flops,
            "peak_int8_ops": chip.peak_int8_ops,
            "peak_fp8_flops": chip.peak_fp8_flops,
            "hbm_bw": chip.hbm_bw,
            "ridge_flops_per_byte": chip.peak_bf16_flops / chip.hbm_bw}


def compute_s(flops: float, chip: ChipSpec, *, flops_int8: float = 0.0,
              flops_fp8: float = 0.0) -> float:
    """Seconds of ``flops`` at the chip's peaks: ``flops_int8`` /
    ``flops_fp8`` of them at the int8 / fp8 rate, the rest at bf16's."""
    rest = flops - flops_int8 - flops_fp8
    return (rest / chip.peak_bf16_flops + flops_int8 / chip.peak_int8_ops
            + flops_fp8 / chip.peak_fp8_flops)


def _roofline(t_compute: float, nbytes: float, chip: ChipSpec
              ) -> tuple[float, str]:
    """(modeled seconds, placement) for a compute time and a modeled byte
    volume."""
    t_traffic = nbytes / chip.hbm_bw if nbytes else 0.0
    placement = "compute-bound" if t_compute >= t_traffic else "memory-bound"
    return max(t_compute, t_traffic), placement


def measured_walls() -> dict[tuple[str, str], dict[str, float]]:
    """Summed ``dispatch:<kind>`` wall scopes keyed by (kind, backend)."""
    out: dict[tuple[str, str], dict[str, float]] = {}
    for s in optrace.spans():
        if s.cat != "wall" or not s.name.startswith(WALL_PREFIX):
            continue
        kind = s.name[len(WALL_PREFIX):]
        backend = str(s.args.get("backend", ""))
        row = out.setdefault((kind, backend), {"wall_s": 0.0, "calls": 0})
        row["wall_s"] += s.dur_s
        row["calls"] += 1
    return out


def kind_rows(chip: ChipSpec | None = None) -> list[dict[str, Any]]:
    """One attribution row per (kind, backend) seen in the op ring.

    Under ring sampling the modeled sums cover only the sampled events;
    the wall scopes are *not* sampled -- they come from the measured side
    -- so a measured kind whose events were sampled away still gets a
    row."""
    chip = _chip(chip)
    groups: dict[tuple[str, str], dict[str, float]] = {}

    def new() -> dict[str, float]:
        return {"count": 0, "flops": 0.0, "bytes": 0.0, "energy_j": 0.0,
                "compute_s": 0.0}

    for ev in optrace.events():
        g = groups.setdefault((ev.kind, ev.backend or ""), new())
        prec = optrace.precision_of(ev.dtype)
        g["count"] += 1
        g["flops"] += ev.flops
        g["bytes"] += ev.bytes
        g["energy_j"] += ev.energy_j
        g["compute_s"] += compute_s(
            ev.flops, chip, flops_int8=ev.flops if prec == "int8" else 0.0,
            flops_fp8=ev.flops if prec == "fp8" else 0.0)
    walls = measured_walls()
    for key in walls:
        groups.setdefault(key, new())
    rows = []
    for (kind, backend), g in sorted(groups.items()):
        modeled_t, placement = _roofline(g["compute_s"], g["bytes"], chip)
        w = walls.get((kind, backend))
        row: dict[str, Any] = {
            "kind": kind,
            "backend": backend,
            "count": int(g["count"]),
            "modeled_flops": g["flops"],
            "modeled_bytes": g["bytes"],
            "modeled_energy_j": g["energy_j"],
            "modeled_time_s": modeled_t,
            "roofline": placement if g["bytes"] or g["flops"] else None,
            "intensity_flops_per_byte":
                g["flops"] / g["bytes"] if g["bytes"] else None,
            "measured_wall_s": w["wall_s"] if w else None,
            "measured_calls": w["calls"] if w else 0,
            "achieved_flops_per_s": None,
            "achieved_bytes_per_s": None,
            "time_error_ratio": None,
            "roofline_share": None,
        }
        if w and w["wall_s"] > 0:
            row["achieved_flops_per_s"] = g["flops"] / w["wall_s"]
            row["achieved_bytes_per_s"] = g["bytes"] / w["wall_s"]
            row["roofline_share"] = modeled_t / w["wall_s"]
            if modeled_t > 0:
                row["time_error_ratio"] = w["wall_s"] / modeled_t
        rows.append(row)
    return rows


def report(chip: ChipSpec | None = None) -> dict[str, Any]:
    """The full attribution report (what ``attribution.json`` holds)."""
    chip = _chip(chip)
    rows = kind_rows(chip)
    return {
        "chip": _chip_info(chip),
        "kinds": rows,
        "totals": _totals(rows),
        "traced": {f"{op}:{kind}": cost for (op, kind), cost
                   in sorted(optrace.traced_costs().items())},
        "ring_events": len(optrace.events()),
        "dropped_ops": optrace.dropped_ops(),
        "sampled_out_ops": optrace.sampled_out_ops(),
        "sample_every": optrace.sample_every(),
    }


def _totals(rows: list[dict[str, Any]]) -> dict[str, Any]:
    tot = {"modeled_flops": 0.0, "modeled_bytes": 0.0,
           "modeled_energy_j": 0.0, "measured_wall_s": 0.0}
    for r in rows:
        tot["modeled_flops"] += r["modeled_flops"]
        tot["modeled_bytes"] += r["modeled_bytes"]
        tot["modeled_energy_j"] += r["modeled_energy_j"]
        tot["measured_wall_s"] += r["measured_wall_s"] or 0.0
    return tot


def write_json(path: str, chip: ChipSpec | None = None) -> dict[str, Any]:
    rep = report(chip)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1, sort_keys=True)
    return rep


def engine_row(*, wall_s: float, modeled: dict[str, float], steps: int,
               covered_steps: int, chip: ChipSpec | None = None
               ) -> dict[str, Any]:
    """The achieved-intensity row engines put in ``last_stats``.

    ``modeled`` sums per-execution step cost (a captured step's traced
    ledger delta, or an eager step's host ledger delta; the keys of
    ``optrace.LEDGER_KEYS``); ``covered_steps`` is how many executed
    steps had a known cost -- steps whose graph was captured before
    telemetry was enabled contribute wall time but no modeled volume, and
    the coverage ratio says so.
    """
    chip = _chip(chip)
    flops = modeled.get("flops", 0.0)
    nbytes = modeled.get("bytes", 0.0)
    modeled_t, placement = _roofline(
        compute_s(flops, chip, flops_int8=modeled.get("flops_int8", 0.0),
                  flops_fp8=modeled.get("flops_fp8", 0.0)), nbytes, chip)
    return {
        "modeled_flops": flops,
        "modeled_bytes": nbytes,
        "modeled_energy_j": modeled.get("energy_j", 0.0),
        "modeled_time_s": modeled_t,
        "roofline": placement if (flops or nbytes) else None,
        "intensity_flops_per_byte": flops / nbytes if nbytes else None,
        "measured_wall_s": wall_s,
        "achieved_flops_per_s": flops / wall_s if wall_s > 0 else None,
        "achieved_bytes_per_s": nbytes / wall_s if wall_s > 0 else None,
        "time_error_ratio":
            wall_s / modeled_t if wall_s > 0 and modeled_t > 0 else None,
        "modeled_step_coverage":
            covered_steps / steps if steps else 0.0,
        "chip": chip.name,
    }


def paper_section(chip: ChipSpec | None = None) -> dict[str, Any]:
    """The ``paper_report["attribution"]`` section: measured kinds only.

    The analytic paper report stands on its own; this section tethers it
    to measurement when telemetry carries any, and says why not when it
    does not."""
    chip = _chip(chip)
    rows = [r for r in kind_rows(chip) if r["measured_wall_s"]]
    if not rows:
        return {"available": False,
                "reason": "no measured dispatch walls; enable "
                          "repro_torch.obs and optrace.configure("
                          "measure_dispatch=True), then run the workload "
                          "eagerly"}
    return {"available": True, "chip": _chip_info(chip), "kinds": rows}
