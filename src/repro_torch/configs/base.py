"""Model configuration schema of the port's language models.

Port of ``repro.configs.base``: the same fields with the same defaults, so
a config compares field for field with the reference's; the parameter and
compute dtypes resolve to torch dtypes.  Every architecture's config is
mirrored, and the port's model runs each of them
(``repro_torch.models.transformer``).
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class StageCfg:
    """A homogeneous run of layers."""

    n_layers: int
    block: str                  # 'dense' | 'moe' | 'mamba1' | 'mamba2' | 'hybrid'
    attn: str = "gqa"           # 'gqa' | 'mla' (attention flavor for attn blocks)
    window: int = 0             # sliding-window size (0 = full attention)
    shared_attn_every: int = 0  # hybrid: one weight-shared attn block per k layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    stages: tuple[StageCfg, ...]
    # attention
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # dense FFN
    d_ff: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    expert_shard: str = "ep"      # 'ep' (experts over model) | 'tp'
    moe_chunk: int = 4096         # tokens-per-row routed per chunk
    aux_loss_weight: float = 0.01
    # MLA
    q_lora: int = 0
    kv_lora: int = 0
    nope_head: int = 0
    rope_head: int = 0
    v_head: int = 0
    # SSM
    ssm_state: int = 0
    d_inner: int = 0
    conv_k: int = 4
    mamba_headdim: int = 64
    dt_rank: int = 0
    ssd_chunk: int = 64
    # frontends / heads
    frontend: str = "none"        # 'none' | 'audio' | 'vlm'
    n_patches: int = 0
    mtp: bool = False
    mtp_weight: float = 0.3
    tie_embeddings: bool = False
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    seq_shard: bool = True
    loss_chunk: int = 512
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    exact_causal: bool = False

    # ---------------------------------------------------------------- utils
    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def vocab_pad(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's layout);
        padded logit columns are masked to -1e30 at decode."""
        return -(-self.vocab // 256) * 256

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for s in self.stages:
            total += s.n_layers * self._block_params(s)
            if s.shared_attn_every:
                total += self._attn_params("gqa") + 3 * d * self.d_ff
        return total

    def _attn_params(self, attn: str) -> int:
        d = self.d_model
        if attn == "mla":
            return (d * self.q_lora
                    + self.q_lora * self.n_heads * (self.nope_head + self.rope_head)
                    + d * (self.kv_lora + self.rope_head)
                    + self.kv_lora * self.n_heads * (self.nope_head + self.v_head)
                    + self.n_heads * self.v_head * d)
        return d * self.n_heads * self.d_head * 2 + d * self.n_kv * self.d_head * 2

    def _block_params(self, s: StageCfg) -> int:
        d = self.d_model
        if s.block == "dense":
            return self._attn_params(s.attn) + 3 * d * self.d_ff
        if s.block == "moe":
            moe = self.n_experts * 3 * d * self.d_ff_expert
            moe += self.n_shared_experts * 3 * d * self.d_ff_expert
            moe += d * self.n_experts
            return self._attn_params(s.attn) + moe
        if s.block == "mamba1":
            di, n = self.d_inner, self.ssm_state
            return (d * 2 * di + self.conv_k * di + di * (self.dt_rank + 2 * n)
                    + self.dt_rank * di + di * n + 2 * di + di * d)
        if s.block in ("mamba2", "hybrid"):
            di, n = self.d_inner, self.ssm_state
            nh = di // self.mamba_headdim
            return d * (2 * di + 2 * n + nh) + di * d
        raise ValueError(s.block)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        moe_layers = sum(s.n_layers for s in self.stages if s.block == "moe")
        all_experts = moe_layers * self.n_experts * 3 * d * self.d_ff_expert
        active = moe_layers * self.top_k * 3 * d * self.d_ff_expert
        return self.param_count() - all_experts + active

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU tests."""
        scale_stage = lambda s: dataclasses.replace(     # noqa: E731
            s, n_layers=min(s.n_layers, 2),
            shared_attn_every=min(s.shared_attn_every, 2) if s.shared_attn_every else 0,
            window=min(s.window, 8) if s.window else 0)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            d_model=64,
            vocab=128,
            n_heads=4 if self.n_heads else 0,
            n_kv=min(self.n_kv, 2) if self.n_kv else 0,
            d_head=16 if self.d_head else 0,
            d_ff=128 if self.d_ff else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=64 if self.d_ff_expert else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            q_lora=32 if self.q_lora else 0,
            kv_lora=16 if self.kv_lora else 0,
            nope_head=16 if self.nope_head else 0,
            rope_head=8 if self.rope_head else 0,
            v_head=16 if self.v_head else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            d_inner=128 if self.d_inner else 0,
            dt_rank=8 if self.dt_rank else 0,
            mamba_headdim=32 if self.d_inner else 64,
            ssd_chunk=8,
            n_patches=min(self.n_patches, 4) if self.n_patches else 0,
            loss_chunk=16,
            attn_block_q=8,
            attn_block_kv=8,
            stages=tuple(scale_stage(s) for s in self.stages),
        )
