"""Falcon-Mamba 7B [arXiv:2410.05355]: pure Mamba-1, attention-free.

d_inner = 2 * d_model = 8192, state 16, dt_rank = d_model / 16 = 256.
"""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    d_model=4096,
    vocab=65024,
    ssm_state=16,
    d_inner=8192,
    dt_rank=256,
    conv_k=4,
    stages=(StageCfg(n_layers=64, block="mamba1"),),
)
