"""The paper's DRAM energy model (the part of ``repro.core.energy_model``
the telemetry needs; the rest of the analytic core is not ported yet).

DRAM: 32-bit LPDDR3 at 800 MHz, 120 pJ per byte (DRAMPower), the paper's
calibration point.  It is a model output of the paper's ASIC, not a
measurement of the H100's HBM3.
"""
from __future__ import annotations

DRAM_ENERGY_PJ_PER_BYTE = 120.0


def dram_energy_joules(traffic_bytes: float) -> float:
    return traffic_bytes * DRAM_ENERGY_PJ_PER_BYTE * 1e-12
