"""Model configuration: a copy of the JAX package's ``ModelConfig`` and
``reduced``.

One decoder-centric description: a repeating *super-block* of per-layer
block types (attention / mamba / mlstm / slstm) and MLP types (dense / moe /
none), plus an optional encoder stack and modality frontends. The port's
``repro_torch.models.model.LM`` builds every kind described here.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "mamba", "mlstm", "slstm"]
MlpKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # Super-block structure; len(block_pattern) must divide n_layers.
    block_pattern: tuple[str, ...] = ("attn",)
    mlp_pattern: tuple[str, ...] = ("dense",)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_ff: int = 0                   # expert hidden size (defaults to d_ff)
    capacity_factor: float = 1.25
    router_noise: bool = False        # stochastic routing via radix-forest QMC

    # Attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    attn_impl: str = "einsum"   # einsum | flash (Pallas online-softmax)

    # SSM (mamba)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # xLSTM
    mlstm_chunk: int = 128

    # Encoder-decoder (Whisper)
    encoder_layers: int = 0
    cross_attention: bool = False

    # Frontend: none -> tokens; embed -> precomputed embeddings (VLM stub);
    # audio -> precomputed frame embeddings into the encoder (conv stub).
    frontend: str = "none"

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # long_500k eligibility: SSM/hybrid/linear-attn (i.e. not *pure* full
    # attention). Hybrid decode is O(S) per token; pure-attention 512k decode
    # is skipped per the assignment.
    @property
    def subquadratic(self) -> bool:
        return any(b != "attn" for b in self.block_pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            self.name, self.n_layers, self.block_pattern)
        return self.n_layers // len(self.block_pattern)

    @property
    def expert_ff(self) -> int:
        return self.moe_ff or self.d_ff

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter estimate (embeddings included)."""
        D, V = self.d_model, self.vocab
        hd = self.hd
        total = V * D * (1 if self.tie_embeddings else 2)
        active = total
        period = len(self.block_pattern)
        for li in range(self.n_layers):
            b = self.block_pattern[li % period]
            m = self.mlp_pattern[li % len(self.mlp_pattern)]
            if b == "attn":
                a = D * self.n_heads * hd * 2 + D * self.n_kv_heads * hd * 2
                if self.cross_attention:
                    a *= 2
            elif b == "mamba":
                di = self.ssm_expand * D
                a = D * di * 2 + di * D + di * (self.ssm_state * 2 + 2) + di * self.ssm_conv
            else:  # mlstm / slstm
                di = 2 * D if b == "mlstm" else D
                a = D * di * 4 + di * D + di * 3
            total += a
            active += a
            if m == "dense":
                f = 3 * D * self.d_ff
                total += f
                active += f
            elif m == "moe":
                f = 3 * D * self.expert_ff
                total += f * (self.n_experts + self.n_shared_experts) + D * self.n_experts
                active += f * (self.top_k + self.n_shared_experts) + D * self.n_experts
        # encoder stack (attention + dense mlp)
        for _ in range(self.encoder_layers):
            a = D * self.n_heads * hd * 2 + D * self.n_kv_heads * hd * 2
            f = 3 * D * self.d_ff
            total += a + f
            active += a + f
        return total, active


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family variant for CPU smoke tests."""
    period = len(cfg.block_pattern)
    small = dict(
        n_layers=period * min(2, cfg.n_periods),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_ff=128 if cfg.moe_ff else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        ssm_state=8,
        mlstm_chunk=16,
        name=cfg.name + "-reduced",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
