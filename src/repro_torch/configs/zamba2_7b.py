"""Zamba2-7B [arXiv:2411.15242]: Mamba-2 backbone + weight-shared attention.

81 Mamba-2 layers with one weight-shared attention+MLP block applied before
every 6th layer (the reference's simplification of the dual block to one
shared block).  d_inner = 2 * d_model = 7168, headdim 64 -> 112 SSD heads,
state 64.
"""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="zamba2-7b",
    d_model=3584,
    vocab=32000,
    n_heads=32,
    n_kv=32,
    d_head=112,
    d_ff=14336,
    ssm_state=64,
    d_inner=7168,
    mamba_headdim=64,
    conv_k=4,
    stages=(StageCfg(n_layers=81, block="hybrid", shared_attn_every=6),),
)
