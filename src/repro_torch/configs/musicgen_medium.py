"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.

The frontend is a stub: precomputed frame embeddings (B, S, d_model) take
the place of token ids; the 4-codebook delay pattern is collapsed to a
single stream of vocab 2048 (backbone shapes unchanged).
"""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="musicgen-medium",
    d_model=1536,
    vocab=2048,
    n_heads=24,
    n_kv=24,
    d_head=64,
    d_ff=6144,
    frontend="audio",
    stages=(StageCfg(n_layers=48, block="dense"),),
)
