"""Yi-9B [arXiv:2403.04652]: llama-architecture dense GQA."""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="yi-9b",
    d_model=4096,
    vocab=64000,
    n_heads=32,
    n_kv=4,
    d_head=128,
    d_ff=11008,
    rope_theta=5e6,
    stages=(StageCfg(n_layers=48, block="dense"),),
)
