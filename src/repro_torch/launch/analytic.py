"""Analytic FLOP / HBM-byte model per (arch x shape) step, a copy of the
JAX package's ``launch/analytic.py``.

Exact matmul counting from the known architecture, pure Python over the
config: on the H100 it gives a step's model FLOPs, whose share of the
card's peak rate a measured step time turns into (``chip_smoke.py``'s
``families_train`` lines).

Conventions: fwd matmul flops = 2*M*N*K; train = 3x fwd (bwd = 2x) for
remat='dots' (matmul outputs saved) and 'none', 4x for remat='full';
attention scores count the full (unmasked) S^2 matmul.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import _pick_groups, capacity


def _attn_flops(cfg: ModelConfig, T: int, S_kv: int, cross_T: int = 0) -> float:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f = 2 * T * D * (H * hd + 2 * KV * hd)          # qkv
    f += 2 * T * S_kv * H * hd * 2                  # scores + weighted sum
    f += 2 * T * H * hd * D                         # out proj
    if cross_T:
        f += 2 * T * D * H * hd + 2 * cross_T * D * 2 * KV * hd
        f += 2 * T * cross_T * H * hd * 2 + 2 * T * H * hd * D
    return f


def _dense_mlp_flops(cfg: ModelConfig, T: int) -> float:
    return 2 * T * cfg.d_model * cfg.d_ff * 3


def _moe_flops(cfg: ModelConfig, T: int) -> float:
    D, E, F, k = cfg.d_model, cfg.n_experts, cfg.expert_ff, cfg.top_k
    G = _pick_groups(T)
    g = T // G
    C = capacity(g, k, E, cfg.capacity_factor)
    f = 2 * T * D * E                                # router
    f += 2 * T * E * C * 2                           # one-hot bookkeeping (cheap)
    f += 2 * G * E * C * D * (2)                     # dispatch + combine gathers
    f += 2 * T * E * C * D                           # dispatch einsum (dense)
    f += 2 * G * E * C * D * F * 3                   # expert ffn
    f += 2 * T * E * C * D                           # combine einsum
    f += 2 * T * D * F * cfg.n_shared_experts * 3    # shared expert
    return f


def _mamba_flops(cfg: ModelConfig, T: int) -> float:
    D = cfg.d_model
    DI = cfg.ssm_expand * D
    N = cfg.ssm_state
    f = 2 * T * D * 2 * DI                           # in_proj
    f += 2 * T * DI * cfg.ssm_conv                   # conv
    f += 2 * T * DI * (2 * N + 1)                    # x_proj
    f += T * DI * N * 8                              # scan combine (assoc)
    f += 2 * T * DI * N                              # y readout
    f += 2 * T * DI * D                              # out_proj
    return f


def _mlstm_flops(cfg: ModelConfig, T: int) -> float:
    D = cfg.d_model
    DI = 2 * D
    H = cfg.n_heads
    hd = DI // H
    L = min(cfg.mlstm_chunk, max(T, 1))
    f = 2 * T * D * 2 * DI + 2 * T * DI * DI * 3 + 2 * T * DI * 2 * H
    f += 2 * T * L * DI * 3                          # intra qk / hv / n
    f += 2 * T * hd * DI * 2                         # inter readout
    f += (T / max(L, 1)) * H * hd * hd * 6           # chunk state update
    f += 2 * T * DI * D                              # down
    return f


def _slstm_flops(cfg: ModelConfig, T: int) -> float:
    D = cfg.d_model
    hd = D // cfg.n_heads
    f = 2 * T * D * 4 * D                            # wx
    f += 2 * T * D * 4 * hd                          # recurrent (block diag)
    f += 30 * T * D                                  # gates/state elementwise
    f += 2 * T * D * D                               # down
    return f


def step_flops(cfg: ModelConfig, kind: str, seq_len: int, batch: int,
               remat: str = "dots") -> dict[str, float]:
    """Global flops for one step of the given shape kind."""
    if kind in ("train", "prefill"):
        T = batch * seq_len
        S_kv = seq_len
    else:  # decode / long: one token, KV length seq_len
        T = batch
        S_kv = seq_len
    period = cfg.block_pattern
    fwd = 0.0
    for li in range(cfg.n_layers):
        b = period[li % len(period)]
        m = cfg.mlp_pattern[li % len(cfg.mlp_pattern)]
        if b == "attn":
            fwd += _attn_flops(
                cfg, T, S_kv, cross_T=batch * seq_len if cfg.cross_attention else 0
            )
        elif b == "mamba":
            fwd += _mamba_flops(cfg, T)
        elif b == "mlstm":
            fwd += _mlstm_flops(cfg, T)
        else:
            fwd += _slstm_flops(cfg, T)
        if m == "dense":
            fwd += _dense_mlp_flops(cfg, T)
        elif m == "moe":
            fwd += _moe_flops(cfg, T)
    # encoder (runs on the full frame sequence even at decode: enc_out given,
    # so only for train/prefill)
    if cfg.encoder_layers and kind in ("train", "prefill"):
        Te = batch * seq_len
        fwd += cfg.encoder_layers * (
            _attn_flops(cfg, Te, seq_len) + _dense_mlp_flops(cfg, Te)
        )
    fwd += 2 * T * cfg.d_model * cfg.vocab           # lm head
    mult = {"train": 4.0 if remat == "full" else 3.0}.get(kind, 1.0)
    return {"fwd_flops": fwd, "step_flops": fwd * mult}


def step_bytes(cfg: ModelConfig, kind: str, seq_len: int, batch: int,
               opt_bytes_per_param: int = 12) -> dict[str, float]:
    """Global HBM bytes for one step (optimistic fused estimate)."""
    total, _ = cfg.param_count()
    dt = 2 if cfg.dtype == "bfloat16" else 4
    if kind == "train":
        T = batch * seq_len
        pbytes = total * (2 * 4 + opt_bytes_per_param)   # fwd+bwd reads + opt
        act = cfg.n_layers * T * cfg.d_model * dt * 6    # save+read, coarse
        act += T * cfg.vocab * 4 * 2                     # logits fwd+bwd
        return {"step_bytes": pbytes + act}
    if kind == "prefill":
        T = batch * seq_len
        return {
            "step_bytes": total * dt
            + cfg.n_layers * T * cfg.d_model * dt * 2
            + T * cfg.vocab * 4 * 0 + batch * cfg.vocab * 4
        }
    # decode: every param + the whole cache is read per token
    cache = 0
    for li in range(cfg.n_layers):
        b = cfg.block_pattern[li % len(cfg.block_pattern)]
        if b == "attn":
            cache += batch * seq_len * cfg.n_kv_heads * cfg.hd * 2 * dt
        elif b == "mamba":
            cache += batch * cfg.ssm_expand * cfg.d_model * cfg.ssm_state * 4
        elif b == "mlstm":
            DI = 2 * cfg.d_model
            cache += batch * DI * (DI // cfg.n_heads) * 4
        else:
            cache += batch * cfg.d_model * 4 * 3
    return {"step_bytes": total * dt + cache + batch * cfg.vocab * 4}
