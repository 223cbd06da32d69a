"""Mixtral 8x7B [arXiv:2401.04088]: 8 experts top-2, sliding-window
attention (window 4096), GQA 32 / 8 heads."""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    d_model=4096,
    vocab=32000,
    n_heads=32,
    n_kv=8,
    d_head=128,
    n_experts=8,
    top_k=2,
    d_ff_expert=14336,
    expert_shard="tp",
    rope_theta=1e6,
    stages=(StageCfg(n_layers=32, block="moe", window=4096),),
)
