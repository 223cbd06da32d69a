"""The NVIDIA H100 as the mapper and the roofline bounds see it.

Published figures (NVIDIA H100 data sheet; dense rates, full power limit):

  * SXM5 (name "NVIDIA H100 80GB HBM3"): 132 SMs, 67 TFLOP/s float32 on
    the CUDA cores, 989 TFLOP/s bf16 and 1,979 TFLOP/s fp8 / TOP/s int8 on
    the tensor cores, 3.35 TB/s HBM3, 80 GB.
  * PCIe (name "NVIDIA H100 PCIe"): 114 SMs, 51 TFLOP/s float32, 756
    TFLOP/s bf16, 1,513 fp8 / int8, 2.0 TB/s HBM2e, 80 GB.
  * NVL (name "NVIDIA H100 NVL"): 132 SMs, 60 TFLOP/s float32, 835 TFLOP/s
    bf16, 1,670 fp8 / int8, 3.9 TB/s, 94 GB.

The tensor-core rates are the data sheets' sparse figures halved (dense).

Every variant lets one thread block use 227 KB (232,448 bytes) of shared
memory, above 48 KB only as opt-in dynamic shared memory.  The variant is
read from the device name, never assumed; a card set below its maximum
power limit runs slower than these peaks.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    sms: int
    smem_per_block: int        # bytes one CTA may opt in to
    peak_fp32_flops: float     # FLOP/s, CUDA-core FMA (no tensor cores)
    peak_int8_ops: float       # OP/s, dense int8 on the tensor cores
    peak_fp8_flops: float      # FLOP/s, dense fp8 on the tensor cores
    peak_bf16_flops: float     # FLOP/s, dense bf16 on the tensor cores
    hbm_bw: float              # bytes/s
    hbm_bytes: float


SMEM_PER_BLOCK = 232_448
# shared memory a CTA gets without cudaFuncSetAttribute
SMEM_STATIC_LIMIT = 48 * 1024

H100_SXM = ChipSpec(name="h100_sxm", sms=132, smem_per_block=SMEM_PER_BLOCK,
                    peak_fp32_flops=67e12, peak_int8_ops=1979e12,
                    peak_fp8_flops=1979e12, peak_bf16_flops=989e12,
                    hbm_bw=3.35e12, hbm_bytes=80e9)
H100_PCIE = ChipSpec(name="h100_pcie", sms=114,
                     smem_per_block=SMEM_PER_BLOCK, peak_fp32_flops=51e12,
                     peak_int8_ops=1513e12, peak_fp8_flops=1513e12,
                     peak_bf16_flops=756e12, hbm_bw=2.0e12, hbm_bytes=80e9)
H100_NVL = ChipSpec(name="h100_nvl", sms=132, smem_per_block=SMEM_PER_BLOCK,
                    peak_fp32_flops=60e12, peak_int8_ops=1670e12,
                    peak_fp8_flops=1670e12, peak_bf16_flops=835e12,
                    hbm_bw=3.9e12, hbm_bytes=94e9)


def chip_from_name(device_name: str) -> ChipSpec:
    """The H100 variant named by ``torch.cuda.get_device_name()``."""
    if "H100" not in device_name:
        raise ValueError(f"not an H100: {device_name!r}")
    if "PCIe" in device_name:
        return H100_PCIE
    if "NVL" in device_name:
        return H100_NVL
    return H100_SXM


def current_chip() -> ChipSpec:
    """The spec of CUDA device 0 (raises without a CUDA device)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the chip spec is read from it")
    return chip_from_name(torch.cuda.get_device_name(0))
