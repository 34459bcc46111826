"""Hand-rolled AdamW with fp32 master weights: the port of
``repro/train/optimizer.py``, as plain functions on dicts of tensors.

Params may live in bf16 (compute copies); the optimizer state carries
fp32 master weights and moments. The update runs in fp32 tensors, step
for step as the reference writes it (the schedule, ``b1 ** step`` and the
clip scale are fp32 0-d tensors, not Python floats); the new compute
params are the masters cast back to each parameter's dtype.

The port updates in place: :func:`adamw_update` writes the new moments
and masters into ``opt_state`` and the new values into ``params``, so a
step holds one copy of the state where the reference, functional, holds
two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.model import LM, reference_key


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def warmup_cosine(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to min_lr_ratio·lr, in float32, on
    ``step``'s device (a Python int: the host's).

    The float32 cosine of torch and of XLA differ by one ulp at some
    arguments, so the rate can differ from the reference's by one ulp on
    the decay (never in the warmup)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict) -> dict:
    """State: dict(master, mu, nu) of fp32 tensors by parameter name, in
    ``params``' order, and ``step``, an int32 0-d tensor."""
    master = {n: p.detach().to(torch.float32, copy=True)
              for n, p in params.items()}
    dev = next(iter(master.values())).device
    return {"master": master,
            "mu": {n: torch.zeros_like(w) for n, w in master.items()},
            "nu": {n: torch.zeros_like(w) for n, w in master.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of each leaf's fp32 sum of squares, the leaves
    added in the dict's order. A leaf's sum is a dot product with itself:
    one read of the leaf, no squared copy (its float32 rounding is not
    the reference's reduction order, which no torch op has)."""
    total = None
    for g in tree.values():
        f = g.float().reshape(-1)
        s = torch.dot(f, f)
        total = s if total is None else total + s
    return torch.sqrt(total)


def reference_decay_mask(model: LM) -> dict:
    """Which parameters the reference decays: it decays a leaf of its tree
    when the leaf has ``ndim >= 2``, and every per-layer leaf inside the
    ``n_groups`` pattern repeats carries a leading (G, ...) axis there. So
    a port parameter decays iff it is at least 2-D, or it belongs to a
    layer of the repeats — a norm scale or bias of a stacked layer decays,
    the same leaf of a remainder layer and ``final_norm`` do not. This is
    the reference's behaviour, kept so the updates agree; its comment
    ("norm scales / biases exempt") holds only for the unstacked leaves.
    """
    cfg = model.cfg
    return {n: p.ndim + (reference_key(cfg, n)[1] is not None) >= 2
            for n, p in model.named_parameters()}


def _adamw_leaf(g, m, v, w, p, *, cfg, scale, b1c, b2c, lr, wd):
    """The reference's update, op for op, on one leaf: m, v, w (the
    master) and p (the compute param; None to leave it) in place, in two
    scratch buffers."""
    g = g.float() * scale
    tmp = torch.mul(g, 1 - cfg.b1)
    m.mul_(cfg.b1).add_(tmp)
    v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    upd = torch.div(m, b1c, out=tmp)                       # mh
    den = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)   # sqrt(vh) + eps
    upd.div_(den)
    if wd:
        upd.add_(torch.mul(w, cfg.weight_decay, out=den))
    w.sub_(upd.mul_(lr))
    if p is not None:
        p.copy_(w)


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: AdamWConfig, decay: dict | None = None):
    """One AdamW step over ``grads`` (by name; the global norm adds the
    leaves in ``grads``' order). ``decay`` says which names take weight
    decay; None decays the leaves with ``ndim >= 2``, the reference's
    rule on its own tree. Updates ``opt_state`` and ``params`` in place
    and returns (params, opt_state, stats dict(lr, grad_norm))."""
    step = opt_state["step"] + 1
    lr = warmup_cosine(cfg, step)
    gnorm = global_norm(grads)
    f32 = dict(dtype=torch.float32, device=gnorm.device)
    # a Python number over a tensor is a reciprocal times the number in
    # torch; the reference divides
    scale = torch.clamp(torch.div(torch.tensor(cfg.grad_clip, **f32),
                                  torch.clamp(gnorm, min=1e-9)), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, **f32), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, **f32), stepf)
    for name, g in grads.items():
        wd = (g.ndim >= 2) if decay is None else decay[name]
        _adamw_leaf(g, opt_state["mu"][name], opt_state["nu"][name],
                    opt_state["master"][name], params[name], cfg=cfg,
                    scale=scale, b1c=b1c, b2c=b2c, lr=lr, wd=wd)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
