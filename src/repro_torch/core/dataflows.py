"""Dataflow definitions and GeMM-dimension mappings (paper Table 1): the
port's copy of ``repro.core.dataflows``.

A GeMM multiplies ``A (M, K) @ B (K, N) -> C (M, N)``.  A systolic array of
shape ``(R, C)`` maps two of the three dimensions spatially (``S_R``, ``S_C``)
and streams the third temporally (``T``):

    OS:  (S_R = M, S_C = N, T = K)   outputs stay in PEs
    WS:  (S_R = K, S_C = M, T = N)   weights preloaded, stay in PEs
    IS:  (S_R = K, S_C = N, T = M)   inputs preloaded, stay in PEs
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


@dataclasses.dataclass(frozen=True)
class SpatioTemporal:
    """Projection of a GeMM onto (spatial-rows, spatial-cols, temporal)."""

    S_R: int
    S_C: int
    T: int


def map_gemm(shape: GemmShape, dataflow: Dataflow) -> SpatioTemporal:
    """Paper Table 1: project GeMM dims onto the array's spatiotemporal dims."""
    if dataflow is Dataflow.OS:
        return SpatioTemporal(S_R=shape.M, S_C=shape.N, T=shape.K)
    if dataflow is Dataflow.WS:
        return SpatioTemporal(S_R=shape.K, S_C=shape.M, T=shape.N)
    if dataflow is Dataflow.IS:
        return SpatioTemporal(S_R=shape.K, S_C=shape.N, T=shape.M)
    raise ValueError(f"unknown dataflow {dataflow}")


ALL_DATAFLOWS = (Dataflow.OS, Dataflow.WS, Dataflow.IS)
