"""DeepSeek-Coder 33B [arXiv:2401.14196]: llama-architecture dense GQA."""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    d_model=7168,
    vocab=32256,
    n_heads=56,
    n_kv=8,
    d_head=128,
    d_ff=19200,
    rope_theta=1e5,
    stages=(StageCfg(n_layers=62, block="dense"),),
)
