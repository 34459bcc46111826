"""The port's MoE (``repro_torch.models.layers.moe_block``): sort-based
dispatch against a per-token python oracle, capacity drops, and the
reference's ``moe_block`` on the same numpy inputs (mirrors
tests/test_moe.py).

With ample capacity (no drops), the sorted scatter/gather dispatch must
equal the naive per-token loop: out[t] = Σ_k w_k · FFN_{e_k}(h_t).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JConfig
from repro.models.layers import moe_block as j_moe_block
from repro_torch.models import ModelConfig
from repro_torch.models.layers import _act, moe_block, norm, top_k


def _cfg(cls, **kw):
    base = dict(name="moe-test", family="moe", n_layers=2, d_model=16,
                n_heads=2, n_kv_heads=2, d_ff=24, vocab_size=64,
                n_experts=4, experts_per_token=2, capacity_factor=8.0,
                dtype="float32", attn_chunk=4, ce_chunk=4)
    base.update(kw)
    return cls(**base)


def _params(cfg, seed, scale=True):
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = (lambda n: 1.0 / np.sqrt(n)) if scale else (lambda n: 1.0)
    return {
        "norm": np.ones((d,), np.float32),
        "router": (rng.standard_normal((d, E)) * (0.5 if scale else 1.0)
                   ).astype(np.float32),
        "ewi": (rng.standard_normal((E, d, ff)) * s(d)).astype(np.float32),
        "ewg": (rng.standard_normal((E, d, ff)) * s(d)).astype(np.float32),
        "ewo": (rng.standard_normal((E, ff, d)) * s(ff)).astype(np.float32),
    }


def _oracle(x, p, cfg):
    """Naive per-token MoE (same router math, no capacity)."""
    B, S, d = x.shape
    h = norm(x, p["norm"], cfg.norm_type).reshape(B * S, d)
    probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
    gv, gi = top_k(probs, cfg.experts_per_token)
    gv = gv / gv.sum(-1, keepdim=True)
    out = np.zeros((B * S, d), np.float32)
    hn = h.numpy()
    for t in range(B * S):
        for k in range(cfg.experts_per_token):
            e = int(gi[t, k])
            u = hn[t] @ p["ewi"][e].numpy()
            if cfg.mlp_gated:
                g = _act(torch.from_numpy(hn[t] @ p["ewg"][e].numpy()),
                         cfg.mlp_act).numpy()
                u = u * g
            else:
                u = _act(torch.from_numpy(u), cfg.mlp_act).numpy()
            out[t] += float(gv[t, k]) * (u @ p["ewo"][e].numpy())
    return out.reshape(B, S, d)


@pytest.mark.parametrize("seq,batch", [(8, 2), (1, 6)])  # prefill & decode
def test_moe_dispatch_matches_per_token_oracle(seq, batch):
    cfg = _cfg(ModelConfig)
    p = {k: torch.from_numpy(v) for k, v in _params(cfg, 0).items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, seq, cfg.d_model)).astype(np.float32))
    got, aux = moe_block(x, p, cfg)
    np.testing.assert_allclose(got.numpy(), _oracle(x, p, cfg), rtol=2e-4,
                               atol=2e-4)
    assert np.isfinite(float(aux)) and float(aux) > 0


@pytest.mark.parametrize("seq,batch,cf", [(8, 2, 8.0), (1, 6, 8.0),
                                          (16, 2, 0.5)])
def test_moe_matches_reference(seq, batch, cf):
    """Slot for slot the reference's dispatch: the same outputs and aux
    loss, with and without capacity drops."""
    cfg, jcfg = _cfg(ModelConfig, capacity_factor=cf), \
        _cfg(JConfig, capacity_factor=cf)
    pn = _params(cfg, 2)
    xn = np.random.default_rng(3).standard_normal(
        (batch, seq, cfg.d_model)).astype(np.float32)
    want, jaux = jax.jit(lambda x, p: j_moe_block(x, p, jcfg, {}))(xn, pn)
    got, aux = moe_block(torch.from_numpy(xn),
                         {k: torch.from_numpy(v) for k, v in pn.items()}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist()


def test_moe_capacity_drops_are_bounded_not_silent():
    """With capacity_factor < 1, some tokens drop — output stays finite and
    the dropped tokens contribute exactly zero."""
    cfg = _cfg(ModelConfig, d_model=8, d_ff=8, experts_per_token=1,
               capacity_factor=0.5)
    p = {k: torch.from_numpy(v) for k, v in
         _params(cfg, 1, scale=False).items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    out, aux = moe_block(x, p, cfg)
    assert torch.isfinite(out).all() and np.isfinite(float(aux))
    # dropped tokens contribute zero (identity via the residual add upstream)
    assert (out.abs().sum(dim=-1) == 0).any()
