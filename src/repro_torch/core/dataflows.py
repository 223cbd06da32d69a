"""Dataflow definitions (paper Table 1): the port's own copy.

A GeMM multiplies ``A (M, K) @ B (K, N) -> C (M, N)``.  The three dataflows
name which operand stays put while the third dimension streams:

    OS:  outputs stationary, K streams
    WS:  weights (B) stationary, M streams
    IS:  inputs (A) stationary, N streams
"""
from __future__ import annotations

import dataclasses
import enum


class Dataflow(enum.Enum):
    OS = "os"  # output stationary
    WS = "ws"  # weight stationary
    IS = "is"  # input stationary


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """A GeMM problem ``(M, K) @ (K, N)``."""

    M: int
    K: int
    N: int

    def __post_init__(self) -> None:
        if min(self.M, self.K, self.N) < 1:
            raise ValueError(f"GeMM dims must be >= 1, got {self}")

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def flops(self) -> int:
        return 2 * self.macs


ALL_DATAFLOWS = (Dataflow.OS, Dataflow.WS, Dataflow.IS)
