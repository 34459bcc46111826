"""Recurrent blocks: Griffin RG-LRU (recurrentgemma) and xLSTM (mLSTM/sLSTM).

The port of ``repro/models/recurrent.py``. Prefill uses parallel forms (a
log-depth scan for RG-LRU, chunkwise-parallel mLSTM); decode uses the
O(1)-state recurrent steps. States are fp32 whatever the activation
dtype (carried across long horizons; bf16 recurrences drift).

Two choices differ from the reference's code, not from its maths:

* the RG-LRU scan is Hillis-Steele doubling over time (⌈log2 S⌉ steps of
  the reference's combine) where the reference runs
  ``lax.associative_scan``: the same products and sums in another
  bracketing, so fp32 results differ in the last bits (the tests hold
  them to 1e-4 in fp32);
* ``mlstm_chunked`` masks the padding steps of its last chunk (log-forget
  0, input gate -1e30), so the carried state is the true one. The
  reference pads with zero gates, and its state then decays by
  sigmoid(0) = 0.5 per padding row; the two agree wherever
  S <= chunk or S % chunk == 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import NEG_INF, _act, norm

RGLRU_C = 8.0


# ------------------------------------------------------------ causal conv1d
def causal_conv1d(x, w, state=None):
    """Depthwise causal conv: x (B,S,D), w (W,D). state: (B,W-1,D) | None.
    Returns (y, new_state); the new state is in x's dtype, as in the
    reference."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):].contiguous() if W > 1 else None
    return y, new_state


# ------------------------------------------------------------ RG-LRU
def _linear_scan(a, b):
    """h_t = a_t·h_{t-1} + b_t along axis 1 with h_{-1} = 0, as ⌈log2 S⌉
    doubling steps of the combine (a1, b1)∘(a2, b2) = (a1·a2, b1·a2 + b2)."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], b[:, :-shift] * a[:, shift:]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def rglru(x, p, state=None):
    """Real-Gated Linear Recurrent Unit (Griffin eq. 1-4).

    x: (B,S,D). r = σ(x@Wa+ba), i = σ(x@Wx+bx), a = exp(-c·softplus(Λ)·r);
    h_t = a·h_{t-1} + sqrt(1-a²)·(i·x). state: (B,D) fp32 h_{-1}.
    Returns (h (B,S,D) in x's dtype, h_last fp32).
    """
    xf = x.float()
    r = torch.sigmoid(xf @ p["wa"] + p["ba"])
    i = torch.sigmoid(xf @ p["wx"] + p["bx"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r                 # (B,S,D) < 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) \
        * (i * xf)
    if state is not None:
        # fold the carried state into the first step's additive term
        b = torch.cat([b[:, :1] + (a[:, 0] * state)[:, None], b[:, 1:]],
                      dim=1)
    h = _linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_block(x, p, cfg, *, state=None):
    """Griffin recurrent block: [linear -> conv1d -> RG-LRU] ⊙ gelu(linear).

    state: None | dict(conv (B,W-1,D), h (B,D)). Returns (out, new_state).
    """
    h = norm(x, p["norm"], cfg.norm_type)
    u = h @ p["w_in"]                                            # (B,S,Dr)
    g = _act(h @ p["w_gate"], "gelu")
    u, new_conv = causal_conv1d(u, p["conv_w"],
                                None if state is None else state["conv"])
    y, h_last = rglru(u, p, state=None if state is None else state["h"])
    out = (y * g) @ p["w_out"]
    new_state = ({"conv": new_conv, "h": h_last}
                 if state is not None else None)
    return out, new_state


# ------------------------------------------------------------ mLSTM
def mlstm_chunked(q, k, v, i_raw, f_raw, *, chunk: int, state=None):
    """Chunkwise-parallel mLSTM (xLSTM §2.3), stabilized.

    q,k,v: (B,S,H,Dh); i_raw,f_raw: (B,S,H) pre-activation gates.
    state: None | (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)) fp32.
    The padding rows of the last chunk get log-forget 0 and input gate
    -1e30, so they neither decay nor feed the carried state.
    Returns (h (B,S,H,Dh), new_state).
    """
    B, S, H, Dh = q.shape
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S

    def pad_t(x, value=0.0):
        return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad), value=value)

    qf = pad_t(q).float().reshape(B, nc, c, H, Dh) / math.sqrt(Dh)
    kf = pad_t(k).float().reshape(B, nc, c, H, Dh)
    vf = pad_t(v).float().reshape(B, nc, c, H, Dh)
    lf = pad_t(F.logsigmoid(f_raw.float())).reshape(B, nc, c, H)
    li = pad_t(i_raw.float(), NEG_INF).reshape(B, nc, c, H)

    if state is None:
        C = torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, Dh), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()

    hs = []
    for j in range(nc):
        qb, kb, vb, lfb, lib = qf[:, j], kf[:, j], vf[:, j], lf[:, j], li[:, j]
        Fc = torch.cumsum(lfb, dim=1)             # (B,c,H) Σ log f (1..t)
        # stabilizer: running max of (F_t + m_prev) and intra (F_t - F_j + li_j)
        a_intra = Fc[:, :, None, :] - Fc[:, None, :, :] + lib[:, None, :, :]
        a_intra = torch.where(tri[None, :, :, None], a_intra, NEG_INF)
        m_inter = Fc + m[:, None, :]                              # (B,c,H)
        m_new_t = torch.maximum(a_intra.amax(dim=2), m_inter)
        # intra-chunk quadratic term
        w = torch.exp(a_intra - m_new_t[:, :, None, :])           # (B,c,c,H)
        s = torch.einsum("bthd,bjhd->btjh", qb, kb)
        h_intra = torch.einsum("btjh,btjh,bjhd->bthd", s, w, vb)
        qn_intra = torch.einsum("btjh,btjh->bth", s, w)
        # inter-chunk term from the carried state
        scale_inter = torch.exp(m_inter - m_new_t)
        h_inter = torch.einsum("bthd,bhde->bthe", qb, C) \
            * scale_inter[..., None]
        n_inter = torch.einsum("bthd,bhd->bth", qb, n) * scale_inter
        qn = qn_intra + n_inter
        hs.append((h_intra + h_inter) / torch.maximum(
            qn.abs(), torch.exp(-m_new_t))[..., None])
        # chunk-end state update
        F_end = Fc[:, -1][:, None, :]                             # (B,1,H)
        m_end = torch.maximum(F_end[:, 0] + m,
                              (F_end - Fc + lib).amax(dim=1))     # (B,H)
        wk = torch.exp(F_end - Fc + lib - m_end[:, None, :])      # (B,c,H)
        decay = torch.exp(F_end[:, 0] + m - m_end)
        C = C * decay[..., None, None] \
            + torch.einsum("bthd,bth,bthe->bhde", kb, wk, vb)
        n = n * decay[..., None] + torch.einsum("bthd,bth->bhd", kb, wk)
        m = m_end

    h = torch.stack(hs, dim=1).reshape(B, nc * c, H, Dh)[:, :S]
    return h.to(q.dtype), (C, n, m)


def mlstm_block(x, p, cfg, *, state=None):
    """mLSTM block: qkv + exponential gating + matrix memory + gated output."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = norm(x, p["norm"], cfg.norm_type)
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, H, hd)
    v = (h @ p["wv"]).reshape(B, S, H, hd)
    i_raw = (h @ p["wi_gate"]).reshape(B, S, H)
    f_raw = (h @ p["wf_gate"]).reshape(B, S, H) + 1.0   # forget bias init
    y, new_state = mlstm_chunked(q, k, v, i_raw, f_raw,
                                 chunk=cfg.attn_chunk, state=state)
    o = torch.sigmoid(h @ p["wo_gate"]).reshape(B, S, H, hd)
    out = (y * o).reshape(B, S, H * hd) @ p["w_out"]
    return out, new_state


# ------------------------------------------------------------ sLSTM
def slstm_block(x, p, cfg, *, state=None):
    """sLSTM: scalar memory, exponential gating, recurrent head mixing.

    Sequential by construction (h_{t-1} feeds the gates through the R
    matrices): one step per token. state: (c, n, h, m) each (B, H, hd)
    fp32. The input projections run in fp32 (the reference's bf16
    weights promote against the fp32 normed input).
    """
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xn = norm(x, p["norm"], cfg.norm_type).float()
    zx, ix, fx, ox = ((xn @ p[w].float()).reshape(B, S, H, hd)
                      for w in ("wz", "wi", "wf", "wo_g"))
    if state is None:
        zeros = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, zeros - 1e30)   # c, n, h, m
    c, n, h, m = state
    Rz, Ri, Rf, Ro = p["rz"], p["ri"], p["rf"], p["ro"]   # (H, hd, hd)

    hs = []
    for t in range(S):
        z = torch.tanh(zx[:, t] + torch.einsum("bhd,hde->bhe", h, Rz))
        li = ix[:, t] + torch.einsum("bhd,hde->bhe", h, Ri)  # log input gate
        lf = F.logsigmoid(fx[:, t] + torch.einsum("bhd,hde->bhe", h, Rf))
        orr = torch.einsum("bhd,hde->bhe", h, Ro)
        m_new = torch.maximum(lf + m, li)
        i_g = torch.exp(li - m_new)
        f_g = torch.exp(lf + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = torch.sigmoid(ox[:, t] + orr) * c / torch.clamp_min(n.abs(), 1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    return y @ p["w_out"], (c, n, h, m)
