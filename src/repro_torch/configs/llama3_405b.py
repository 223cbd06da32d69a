"""Llama-3 405B [arXiv:2407.21783]: dense GQA, 128k vocab."""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="llama3-405b",
    d_model=16384,
    vocab=128256,
    n_heads=128,
    n_kv=8,
    d_head=128,
    d_ff=53248,
    rope_theta=5e5,
    stages=(StageCfg(n_layers=126, block="dense"),),
)
