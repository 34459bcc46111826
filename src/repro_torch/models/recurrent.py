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

Without a state (``forward`` without a cache, which drops the new state)
``mlstm_chunked`` skips the last chunk's ``C``/``n`` update, which
nothing reads: XLA drops it from the reference's compiled forward as
dead code.

Over a mesh (``model.py``'s mesh routes) each entry of a DP row computes
its share: :func:`rglru_entries` a block of the recurrence's channels,
the mLSTM (:func:`mlstm_block` on an entry's weights) and
:func:`slstm_entries` a block of heads, or a block of one head's value
columns (``sharding.head_shares``). Each returns the entry's partial
output (through its rows of ``w_out``), which the row all-reduces, and
its block of the new state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import sharding as shd
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


def rglru(x, p, state=None, *, gates_in=None):
    """Real-Gated Linear Recurrent Unit (Griffin eq. 1-4).

    x: (B,S,D). r = σ(x@Wa+ba), i = σ(x@Wx+bx), a = exp(-c·softplus(Λ)·r);
    h_t = a·h_{t-1} + sqrt(1-a²)·(i·x). state: (B,D) fp32 h_{-1}.
    ``gates_in`` (default x) is the gates' input: over a mesh, the whole
    of the recurrence's input while x is an entry's channels (and the
    weights its columns of Wa, Wx and its block of ba, bx, Λ).
    Returns (h (B,S,D) in x's dtype, h_last fp32).
    """
    xf = x.float()
    gf = xf if gates_in is None else gates_in.float()
    r = torch.sigmoid(gf @ p["wa"] + p["ba"])
    i = torch.sigmoid(gf @ p["wx"] + p["bx"])
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


def _rglru_in(x, p, cfg, state):
    """The block's input side: (u after the conv, the gelu gate, the new
    conv state), on the channels of the weights given."""
    h = norm(x, p["norm"], cfg.norm_type)
    u = h @ p["w_in"]                                            # (B,S,Dr)
    g = _act(h @ p["w_gate"], "gelu")
    u, new_conv = causal_conv1d(u, p["conv_w"],
                                None if state is None else state["conv"])
    return u, g, new_conv


def _rglru_out(u, g, new_conv, p, state, gates_in=None):
    y, h_last = rglru(u, p, state=None if state is None else state["h"],
                      gates_in=gates_in)
    out = (y * g) @ p["w_out"]
    new_state = ({"conv": new_conv, "h": h_last}
                 if state is not None else None)
    return out, new_state


def rglru_block(x, p, cfg, *, state=None):
    """Griffin recurrent block: [linear -> conv1d -> RG-LRU] ⊙ gelu(linear).

    state: None | dict(conv (B,W-1,D), h (B,D)). Returns (out, new_state).
    """
    return _rglru_out(*_rglru_in(x, p, cfg, state), p, state)


def rglru_entries(xs, ps, cfg, mesh, row, shares, states=None):
    """The RG-LRU block over a mesh row, by channel blocks of the
    recurrence width: ``shares`` maps each entry of the row to its
    channels [lo, hi); ``xs`` and ``ps`` map each computing entry to its
    input (B_r, S, d) and weights — its columns of ``w_in``, ``w_gate``,
    ``conv_w``, ``wa`` and ``wx``, its block of ``ba``, ``bx`` and
    ``lam``, its rows of ``w_out``; ``states`` (or None) to its block of
    dict(conv, h). The conv's output is all-gathered over the row's
    entries, since the gates read all of it; the scan runs on the
    entry's channels. Returns (each entry's partial output, which the
    row all-reduces, and its block of the new state or None)."""
    ins = {e: _rglru_in(x, ps[e], cfg, None if states is None else states[e])
           for e, x in xs.items()}
    us = mesh.all_gather({e: v[0] for e, v in ins.items()}, row.entries,
                         "all-gather", stand_in=_stand_in(shares))
    parts, new = {}, {}
    for e, (u, g, conv) in ins.items():
        st = None if states is None else states[e]
        parts[e], new[e] = _rglru_out(u, g, conv, ps[e], st,
                                      torch.cat(us[e], dim=-1))
    return parts, (new if states is not None else None)


def _stand_in(shares: dict):
    """Inside ``Mesh.walk``, another entry's piece: zeros as wide on the
    last dim as its share (lo, hi) or (.., .., lo, hi)."""
    def stand_in(e, own):
        lo, hi = shares[e][-2:]
        return shd.stand_in_like(own, own.shape[:-1] + (hi - lo,))
    return stand_in


# ------------------------------------------------------------ mLSTM
def mlstm_chunked(q, k, v, i_raw, f_raw, *, chunk: int, state=None):
    """Chunkwise-parallel mLSTM (xLSTM §2.3), stabilized.

    q,k: (B,S,H,Dh); v: (B,S,H,Dv) (an entry's block of the value
    columns over a mesh, else Dv = Dh); i_raw,f_raw: (B,S,H)
    pre-activation gates. state: None | (C (B,H,Dh,Dv), n (B,H,Dh),
    m (B,H)) fp32. The padding rows of the last chunk get log-forget 0
    and input gate -1e30, so they neither decay nor feed the carried
    state. Without a state (``forward`` without a cache, which drops the
    new one) the last chunk's C/n update is skipped and the new state is
    None. Returns (h (B,S,H,Dv), new_state).
    """
    B, S, H, Dh = q.shape
    Dv = v.shape[-1]
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S

    def pad_t(x, value=0.0):
        return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad), value=value)

    qf = pad_t(q).float().reshape(B, nc, c, H, Dh) / math.sqrt(Dh)
    kf = pad_t(k).float().reshape(B, nc, c, H, Dh)
    vf = pad_t(v).float().reshape(B, nc, c, H, Dv)
    lf = pad_t(F.logsigmoid(f_raw.float())).reshape(B, nc, c, H)
    li = pad_t(i_raw.float(), NEG_INF).reshape(B, nc, c, H)

    carry = state is not None
    if state is None:
        C = torch.zeros((B, H, Dh, Dv), dtype=torch.float32, device=q.device)
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
        if j == nc - 1 and not carry:
            break
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

    h = torch.stack(hs, dim=1).reshape(B, nc * c, H, Dv)[:, :S]
    return h.to(q.dtype), ((C, n, m) if carry else None)


def mlstm_block(x, p, cfg, *, state=None):
    """mLSTM block: qkv + exponential gating + matrix memory + gated output.

    The heads and value columns are read off the weights: over a mesh an
    entry's share (its heads' columns of ``wq``, ``wk``, ``wi_gate`` and
    ``wf_gate``; of ``wv``, ``wo_gate`` and the rows of ``w_out``, its
    value columns of those heads) gives its partial output and its block
    of the state. Without a state the new one is dropped (None)."""
    B, S, _ = x.shape
    hd = cfg.hd
    h = norm(x, p["norm"], cfg.norm_type)
    q = (h @ p["wq"]).reshape(B, S, -1, hd)
    H = q.shape[2]
    k = (h @ p["wk"]).reshape(B, S, H, hd)
    v = (h @ p["wv"]).reshape(B, S, H, -1)
    i_raw = (h @ p["wi_gate"]).reshape(B, S, H)
    f_raw = (h @ p["wf_gate"]).reshape(B, S, H) + 1.0   # forget bias init
    y, new_state = mlstm_chunked(q, k, v, i_raw, f_raw,
                                 chunk=cfg.attn_chunk, state=state)
    o = torch.sigmoid(h @ p["wo_gate"]).reshape(B, S, H, -1)
    out = (y * o).reshape(B, S, -1) @ p["w_out"]
    return out, new_state


# ------------------------------------------------------------ sLSTM
def _slstm_in(x, p, cfg):
    """The input projections (z, i, f, o), each (B, S, H, Dc) in fp32 (the
    reference's bf16 weights promote against the fp32 normed input); H
    and Dc read off the recurrent matrices (an entry's share)."""
    B, S, _ = x.shape
    H, Dc = p["rz"].shape[0], p["rz"].shape[2]
    xn = norm(x, p["norm"], cfg.norm_type).float()
    return tuple((xn @ p[w].float()).reshape(B, S, H, Dc)
                 for w in ("wz", "wi", "wf", "wo_g"))


def _slstm_zero(B, H, Dc, device):
    zeros = torch.zeros((B, H, Dc), dtype=torch.float32, device=device)
    return (zeros, zeros, zeros, zeros - 1e30)   # c, n, h, m


def _slstm_step(pre, t, h_all, state, p):
    """Step t: ``h_all`` (B, H, hd) the previous h of the whole heads,
    ``state`` (c, n, h, m) of the share's columns."""
    c, n, _, m = state
    zx, ix, fx, ox = pre
    z = torch.tanh(zx[:, t] + torch.einsum("bhd,hde->bhe", h_all, p["rz"]))
    li = ix[:, t] + torch.einsum("bhd,hde->bhe", h_all, p["ri"])  # log input
    lf = F.logsigmoid(fx[:, t] + torch.einsum("bhd,hde->bhe", h_all,
                                              p["rf"]))
    orr = torch.einsum("bhd,hde->bhe", h_all, p["ro"])
    m_new = torch.maximum(lf + m, li)
    i_g = torch.exp(li - m_new)
    f_g = torch.exp(lf + m - m_new)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = torch.sigmoid(ox[:, t] + orr) * c / torch.clamp_min(n.abs(), 1.0)
    return c, n, h, m_new


def slstm_block(x, p, cfg, *, state=None):
    """sLSTM: scalar memory, exponential gating, recurrent head mixing.

    Sequential by construction (h_{t-1} feeds the gates through the R
    matrices): one step per token. state: (c, n, h, m) each (B, H, hd)
    fp32. The input projections run in fp32 (the reference's bf16
    weights promote against the fp32 normed input).
    """
    B, S, _ = x.shape
    pre = _slstm_in(x, p, cfg)
    if state is None:
        state = _slstm_zero(B, pre[0].shape[2], pre[0].shape[3], x.device)
    hs = []
    for t in range(S):
        state = _slstm_step(pre, t, state[2], state, p)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).reshape(B, S, -1).to(x.dtype)
    return y @ p["w_out"], state


def slstm_entries(xs, ps, cfg, mesh, row, shares, states=None):
    """The sLSTM over a mesh row by head: ``shares`` maps each entry of
    the row to (first head, end head, first column, end column)
    (``sharding.head_shares``); ``xs`` and ``ps`` map each computing
    entry to its input and weights — its columns of ``wz``, ``wi``,
    ``wf`` and ``wo_g``, its heads' output columns of the R matrices,
    its rows of ``w_out``; ``states`` (or None) to its block of (c, n,
    h, m). R mixes only within a head, so whole heads need nothing of
    the others; entries that share a head all-gather their columns of
    h within it before each step. Returns (each entry's partial output,
    which the row all-reduces, and its block of the new state or
    None)."""
    B, S, _ = next(iter(xs.values())).shape
    pre = {e: _slstm_in(x, ps[e], cfg) for e, x in xs.items()}
    st = {e: states[e] if states is not None else _slstm_zero(
        B, p[0].shape[2], p[0].shape[3], xs[e].device)
        for e, p in pre.items()}
    # the entries holding each computing entry's heads, in column order
    groups = {tuple(f for f in row.entries if shares[f][0] == shares[e][0])
              for e in xs}
    hs = {e: [] for e in xs}
    for t in range(S):
        h_all = {}
        for g in groups:
            got = mesh.all_gather({e: st[e][2] for e in g if e in st}, g,
                                  "all-gather", stand_in=_stand_in(shares))
            h_all.update({e: v[0] if len(v) == 1 else torch.cat(v, dim=-1)
                          for e, v in got.items()})
        for e in st:
            st[e] = _slstm_step(pre[e], t, h_all[e], st[e], ps[e])
            hs[e].append(st[e][2])
    parts = {e: torch.stack(h, dim=1).reshape(B, S, -1).to(xs[e].dtype)
             @ ps[e]["w_out"] for e, h in hs.items()}
    return parts, (st if states is not None else None)
