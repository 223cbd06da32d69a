"""Qwen2.5-14B [hf:Qwen/Qwen2.5]: dense GQA with QKV bias."""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    d_model=5120,
    vocab=152064,
    n_heads=40,
    n_kv=8,
    d_head=128,
    d_ff=13824,
    qkv_bias=True,
    rope_theta=1e6,
    stages=(StageCfg(n_layers=48, block="dense"),),
)
