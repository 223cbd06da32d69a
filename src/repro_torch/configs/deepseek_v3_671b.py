"""DeepSeek-V3 671B [arXiv:2412.19437]: MLA + 1 shared / 256 routed top-8
MoE + MTP.

61 layers: the first 3 dense (d_ff 18432), the other 58 MoE with an expert
size of 2048.  Multi-head latent attention: queries through a rank-1536
bottleneck, keys and values through a shared 512-wide latent plus one
64-wide RoPE key channel (``models.mla``).
"""
from repro_torch.configs.base import ModelConfig, StageCfg

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168,
    vocab=129280,
    n_heads=128,
    n_kv=128,
    d_head=128,
    d_ff=18432,
    n_experts=256,
    top_k=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    expert_shard="tp",
    q_lora=1536,
    kv_lora=512,
    nope_head=128,
    rope_head=64,
    v_head=128,
    rope_theta=1e4,
    mtp=True,
    stages=(
        StageCfg(n_layers=3, block="dense", attn="mla"),
        StageCfg(n_layers=58, block="moe", attn="mla"),
    ),
)
