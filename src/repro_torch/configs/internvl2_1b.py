"""InternVL2-1B [arXiv:2404.16821]: Qwen2-0.5B LM backbone behind a stub
vision frontend: precomputed patch embeddings (B, 256, d_model) go before
the text tokens in the uncached forward; tied embeddings."""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="internvl2-1b",
    d_model=896,
    vocab=151655,
    n_heads=14,
    n_kv=2,
    d_head=64,
    d_ff=4864,
    qkv_bias=True,
    rope_theta=1e6,
    frontend="vlm",
    n_patches=256,
    tie_embeddings=True,
    stages=(StageCfg(n_layers=24, block="dense"),),
)
