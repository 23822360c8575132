"""xLSTM blocks (xlstm-1.3b): the chunkwise mLSTM and the recurrent sLSTM,
the port of the JAX package's ``models/xlstm.py``.

mLSTM keeps a matrix memory C (H, hd, hd) with input/forget gating:
    C_t = f_t C_{t-1} + i_t v_t k_t^T,  n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (q_t C_t) / max(|q_t . n_t|, 1)
The full-sequence form is chunkwise: quadratic within a chunk, recurrent
over chunks in log-forget space, the same einsums as the JAX package (so
the same roundings in the model dtype). sLSTM is the scalar-memory variant
with exponential gating and the max-stabilizer ``m`` (starting at
``-1e30``); it is sequential, a loop over time here as a ``lax.scan`` there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _dtype, _f32, _weight


# ------------------------------------------------------------------- mLSTM


class MLSTM(nn.Module):
    """Parameters of one mLSTM block (DI = 2 D): ``up`` (2 DI, D), ``wq``/
    ``wk``/``wv`` (DI, DI), ``wif`` (2 H, DI), ``down`` (D, DI) in the
    parameter dtype; ``if_bias`` (2 H,) float32."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        DI = 2 * D
        dt = param_dtype or _dtype(cfg)
        self.up = _weight(2 * DI, D, dtype=dt, device=device)
        self.wq = _weight(DI, DI, dtype=dt, device=device)
        self.wk = _weight(DI, DI, dtype=dt, device=device)
        self.wv = _weight(DI, DI, dtype=dt, device=device)
        self.wif = _weight(2 * H, DI, dtype=dt, device=device)
        self.if_bias = _f32(torch.empty(2 * H, device=device))
        self.down = _weight(D, DI, dtype=dt, device=device)


def _mlstm_chunk_scan(q, k, v, log_f, log_i, chunk: int):
    """q/k/v (B, S, H, hd); log_f/log_i (B, S, H). Returns h (B, S, H, hd)."""
    B, S, H, hd = q.shape
    C = chunk
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {C}")
    nc = S // C
    dt = q.dtype
    qc = q.reshape(B, nc, C, H, hd)
    kc = k.reshape(B, nc, C, H, hd)
    vc = v.reshape(B, nc, C, H, hd)
    lf = log_f.reshape(B, nc, C, H).to(torch.float32)
    li = log_i.reshape(B, nc, C, H).to(torch.float32)

    Fc = torch.cumsum(lf, dim=2)                 # within-chunk cumulative log f
    Ftot = Fc[:, :, -1]                          # (B, nc, H)
    # intra-chunk decay: D[j, t] = exp(F_j - F_t + li_t) for t <= j
    decay = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    ar = torch.arange(C, device=q.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    intra = torch.where(mask, torch.exp(torch.clamp(decay, max=20.0)), 0.0)

    qk = torch.einsum("bnjhd,bnthd->bnjth", qc, kc).to(torch.float32)
    w = (qk * intra).to(dt)                      # (B, nc, j, t, H)
    h_intra = torch.einsum("bnjth,bnthd->bnjhd", w, vc)
    n_intra = torch.einsum("bnjth,bnthd->bnjhd", w, kc)

    # inter-chunk state: Cc = exp(Ftot) C_prev + sum_t exp(Ftot - F_t + li_t) v_t k_t^T
    gain = torch.exp(torch.clamp(Ftot[:, :, None, :] - Fc + li, max=20.0)).to(dt)
    dC = torch.einsum("bnth,bnthd,bnthe->bnhde", gain, vc, kc)
    dn = torch.einsum("bnth,bnthd->bnhd", gain, kc)
    Cst = torch.zeros(B, H, hd, hd, dtype=dt, device=q.device)
    nst = torch.zeros(B, H, hd, dtype=dt, device=q.device)
    Cprev, nprev = [], []
    for i in range(nc):
        Cprev.append(Cst)
        nprev.append(nst)
        decay_c = torch.exp(torch.clamp(Ftot[:, i], max=0.0))       # (B, H)
        Cst = Cst * decay_c[:, :, None, None].to(dt) + dC[:, i]
        nst = nst * decay_c[:, :, None].to(dt) + dn[:, i]
    Cprev = torch.stack(Cprev, dim=1)            # (B, nc, H, hd, hd) state entering chunk
    nprev = torch.stack(nprev, dim=1)            # (B, nc, H, hd)

    carry_w = torch.exp(torch.clamp(Fc, max=0.0)).to(dt)   # exp(F_j) <= 1
    h_inter = torch.einsum("bnjh,bnjhd,bnhde->bnjhe", carry_w, qc, Cprev)
    n_inter = torch.einsum("bnjh,bnjhd,bnhd->bnjh", carry_w, qc, nprev)
    qn = torch.einsum("bnjhd,bnjhd->bnjh", qc, n_intra) + n_inter
    denom = torch.clamp(torch.abs(qn.to(torch.float32)), min=1.0)[..., None]
    h = (h_intra + h_inter).to(torch.float32) / denom
    return h.reshape(B, S, H, hd).to(dt)


def _mlstm_inputs(p: MLSTM, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, D) -> (q, k scaled by 1/sqrt(hd), v (B, S, H, hd), gates
    (B, S, 2 H) float32 with the bias, z (B, S, DI))."""
    B, S, _ = x.shape
    H, dt = cfg.n_heads, x.dtype
    xin, z = torch.chunk(F.linear(x, p.up.to(dt)), 2, dim=-1)
    hd = xin.shape[-1] // H
    q = F.linear(xin, p.wq.to(dt)).view(B, S, H, hd)
    k = F.linear(xin, p.wk.to(dt)).view(B, S, H, hd) * (1.0 / math.sqrt(hd))
    v = F.linear(xin, p.wv.to(dt)).view(B, S, H, hd)
    gates = F.linear(xin, p.wif.to(dt)).to(torch.float32) + p.if_bias
    return q, k, v, gates, z


def _mlstm(p: MLSTM, cfg: ModelConfig, x: torch.Tensor):
    """(y, k, v, log_i, log_f) of the full-sequence forward."""
    B, S, _ = x.shape
    H = cfg.n_heads
    q, k, v, gates, z = _mlstm_inputs(p, cfg, x)
    log_i = torch.clamp(gates[..., :H], max=10.0)      # exp input gate, capped
    log_f = F.logsigmoid(gates[..., H:])               # sigmoid forget gate
    chunk = min(cfg.mlstm_chunk, S)
    while S % chunk:
        chunk -= 1
    h = _mlstm_chunk_scan(q, k, v, log_f, log_i, chunk)
    h = h.reshape(B, S, -1) * F.silu(z)
    return F.linear(h, p.down.to(x.dtype)), k, v, log_i, log_f


def mlstm(p: MLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward (x (B, S, D) -> (B, S, D)) through the chunk
    scan, the chunk cut down to a divisor of S as JAX cuts it."""
    return _mlstm(p, cfg, x)[0]


def mlstm_prefill(p: MLSTM, cfg: ModelConfig, x: torch.Tensor):
    """The forward and the float32 state after the sequence: ``C = sum_t
    exp(F_S - F_t) i_t v_t k_t^T`` and ``n = sum_t exp(F_S - F_t) i_t
    k_t`` (F the cumulative log forget gate), the closed form of the
    recurrence that JAX's ``_mlstm_prefill`` steps through, in one product."""
    y, k, v, li, log_f = _mlstm(p, cfg, x)
    Fc = torch.cumsum(log_f, dim=1)                                     # (B, S, H)
    w = torch.exp(Fc[:, -1:] - Fc + li)                                 # (B, S, H)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    C = torch.einsum("bsh,bshd,bshe->bhde", w, vf, kf)
    n = torch.einsum("bsh,bshd->bhd", w, kf)
    return y, {"C": C, "n": n}


def mlstm_init_cache(cfg: ModelConfig, B: int, dtype=None, device=None,
                     periods: int | None = None):
    """Zero decode state, float32: ``C`` (B, H, hd, hd), ``n`` (B, H, hd);
    with ``periods``, stacked over a leading axis."""
    H = cfg.n_heads
    hd = 2 * cfg.d_model // H
    lead = () if periods is None else (periods,)
    return {"C": torch.zeros(*lead, B, H, hd, hd, dtype=torch.float32, device=device),
            "n": torch.zeros(*lead, B, H, hd, dtype=torch.float32, device=device)}


def mlstm_decode(p: MLSTM, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One-token step. x (B, 1, D) -> (y (B, 1, D), the new state)."""
    B = x.shape[0]
    H, dt = cfg.n_heads, x.dtype
    xin, z = torch.chunk(F.linear(x, p.up.to(dt)), 2, dim=-1)
    DI = xin.shape[-1]
    hd = DI // H
    q, k, v = (F.linear(xin, w.to(dt)).view(B, H, hd) for w in (p.wq, p.wk, p.wv))
    gates = (F.linear(xin, p.wif.to(dt)).to(torch.float32) + p.if_bias)[:, 0]
    i = torch.exp(torch.clamp(gates[..., :H], max=10.0))
    f = torch.sigmoid(gates[..., H:])
    qf = q.to(torch.float32)
    kf = k.to(torch.float32) / math.sqrt(hd)
    vf = v.to(torch.float32)
    C = cache["C"] * f[..., None, None] + i[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", vf, kf)
    n = cache["n"] * f[..., None] + i[..., None] * kf
    num = torch.einsum("bhde,bhe->bhd", C, qf)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, qf))[..., None], min=1.0)
    h = (num / den).reshape(B, 1, DI).to(dt) * F.silu(z)
    return F.linear(h, p.down.to(dt)), {"C": C, "n": n}


def init_mlstm_(p: MLSTM, cfg: ModelConfig, normal_) -> None:
    D, H = cfg.d_model, cfg.n_heads
    DI = 2 * D
    normal_(p.up, 1.0 / math.sqrt(D))
    for w in (p.wq, p.wk, p.wv):
        normal_(w, 1.0 / math.sqrt(DI))
    normal_(p.wif, 0.02)
    p.if_bias[:H] = -3.0     # input gate low
    p.if_bias[H:] = 3.0      # forget gate high
    normal_(p.down, 1.0 / math.sqrt(DI))


# ------------------------------------------------------------------- sLSTM


class SLSTM(nn.Module):
    """Parameters of one sLSTM block: ``wx`` (4 D, D), ``r`` (H, hd, 4 hd)
    (the JAX layout, per head) and ``down`` (D, D) in the parameter dtype;
    ``bias`` (4 D,) float32."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        hd = D // H
        dt = param_dtype or _dtype(cfg)
        self.wx = _weight(4 * D, D, dtype=dt, device=device)
        self.r = _weight(H, hd, 4 * hd, dtype=dt, device=device)
        self.bias = _f32(torch.empty(4 * D, device=device))
        self.down = _weight(D, D, dtype=dt, device=device)


def _slstm_cell(p: SLSTM, cfg: ModelConfig, wx_t: torch.Tensor, state):
    """wx_t (B, 4 D) the input projection; state (h, c, n, m) each (B, H,
    hd), h in the model dtype, the rest float32."""
    h, c, n, m = state
    B = wx_t.shape[0]
    H = cfg.n_heads
    hd = cfg.d_model // H
    rec = torch.einsum("bhd,hde->bhe", h, p.r.to(h.dtype))              # (B, H, 4 hd)
    z = wx_t.reshape(B, H, 4 * hd) + rec
    z = z.to(torch.float32) + p.bias.reshape(H, 4 * hd)
    zi, zz, zf, zo = torch.chunk(z, 4, dim=-1)
    m_new = torch.maximum(zf + m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(zf + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = f * n + i
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1.0)
    return h_new.to(h.dtype), c_new, n_new, m_new


def slstm_init_cache(cfg: ModelConfig, B: int, dtype, device=None,
                     periods: int | None = None):
    """Zero decode state: ``h`` (B, H, hd) in ``dtype``, ``c`` and ``n``
    zeros and ``m`` at ``-1e30``, float32; with ``periods``, stacked over a
    leading axis."""
    H = cfg.n_heads
    shape = (() if periods is None else (periods,)) + (B, H, cfg.d_model // H)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, dtype=dtype, device=device),
            "c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, -1e30, **f32)}


def slstm_prefill(p: SLSTM, cfg: ModelConfig, x: torch.Tensor):
    """The forward over time and its final state (h, c, n, m), which is the
    state JAX's ``_slstm_prefill`` recomputes with a second scan."""
    B, S, D = x.shape
    wx = F.linear(x, p.wx.to(x.dtype))
    st = slstm_init_cache(cfg, B, x.dtype, x.device)
    state = (st["h"], st["c"], st["n"], st["m"])
    hs = []
    for t in range(S):
        state = _slstm_cell(p, cfg, wx[:, t], state)
        hs.append(state[0])
    y = torch.stack(hs, dim=1).reshape(B, S, D)
    return F.linear(y, p.down.to(x.dtype)), dict(zip("hcnm", state))


def slstm(p: SLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: x (B, S, D) -> (B, S, D)."""
    return slstm_prefill(p, cfg, x)[0]


def slstm_decode(p: SLSTM, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One-token step. x (B, 1, D) -> (y (B, 1, D), the new state)."""
    wx = F.linear(x, p.wx.to(x.dtype))[:, 0]
    h, c, n, m = _slstm_cell(p, cfg, wx, (cache["h"], cache["c"], cache["n"], cache["m"]))
    y = h.reshape(x.shape[0], 1, cfg.d_model)
    return F.linear(y, p.down.to(x.dtype)), {"h": h, "c": c, "n": n, "m": m}


def init_slstm_(p: SLSTM, cfg: ModelConfig, normal_) -> None:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    normal_(p.wx, 1.0 / math.sqrt(D))
    normal_(p.r, 0.3 / math.sqrt(hd))
    p.bias.zero_()
    p.bias[2 * D:3 * D] = 1.0   # forget bias
    normal_(p.down, 1.0 / math.sqrt(D))
