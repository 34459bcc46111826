"""Gradient compression: int8 quantized data-parallel mean with error
feedback — the port of ``repro/train/compression.py``.

* ``quantize_int8`` / ``dequantize_int8`` — blockwise symmetric int8
  (scale = max|g|/127 per 2048-block): a 4x traffic cut, one fp32 scale
  per block. ``torch.round`` rounds half to even, as ``jnp.round`` does,
  so both are bit-exact against the reference.
* ``compressed_dp_mean`` — the int8 mean over the shards, with each
  shard's quantization residual returned for error feedback (Karimireddy
  et al. 2019).
* ``make_compressed_dp_step`` — a complete explicit-DP SGD step.

The reference runs the shards as a ``shard_map`` over a mesh axis; the
port takes one torch device per shard (repeats allowed), computes each
shard's grads on its device and sums the dequantized payloads on the
first device — the explicit collective that the compression models.
"""
from __future__ import annotations

import torch

from ..util import tree_flatten, tree_unflatten

BLOCK = 2048


def quantize_int8(g: torch.Tensor, block: int = BLOCK):
    """g (flat fp32) -> (q (nb, block) int8, scales (nb, 1) fp32, true_len)."""
    n = g.shape[0]
    nb = -(-n // block)
    gp = torch.nn.functional.pad(g, (0, nb * block - n)).reshape(nb, block)
    scale = gp.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(gp / scale.clamp_min(1e-12)).clamp(-127, 127).to(
        torch.int8)
    return q, scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int):
    return (q.float() * scale).reshape(-1)[:n]


def compressed_dp_mean(g_flats: list):
    """int8-compressed mean of the shards' flat fp32 grads (one per
    shard, each on its shard's device).

    Returns (mean fp32 on the first shard's device; residuals, one per
    shard on its device) — the residual is
    what quantization lost locally; callers add it to the next step's
    gradient (error feedback). The sum runs over the dequantized
    payloads, modelling the 4x-smaller transfer.
    """
    device = g_flats[0].device
    total, residuals = None, []
    for g in g_flats:
        deq = dequantize_int8(*quantize_int8(g))
        residuals.append(g - deq)
        deq = deq.to(device)
        total = deq if total is None else total + deq
    return total / float(len(g_flats)), residuals


def tree_to_vec(tree):
    """A tree of tensors as one flat fp32 vector (leaves in sorted-key
    order, as the reference flattens) and what :func:`vec_to_tree` needs
    to rebuild it with each leaf's shape and dtype."""
    leaves = [x for _, x in tree_flatten(tree)]
    vec = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
    return vec, (tree, [x.numel() for x in leaves],
                 [x.shape for x in leaves], [x.dtype for x in leaves])


def vec_to_tree(vec: torch.Tensor, meta):
    like, sizes, shapes, dtypes = meta
    out, off = [], 0
    for sz, shp, dt in zip(sizes, shapes, dtypes):
        out.append(vec[off:off + sz].reshape(shp).to(dt))
        off += sz
    return tree_unflatten(like, out)


def make_compressed_dp_step(loss_fn, devices, lr: float = 1e-2,
                            error_feedback: bool = True):
    """Explicit-DP SGD step with an int8-compressed gradient mean.

    loss_fn(params, batch) -> scalar tensor; params (a tree of tensors)
    are replicated, one copy per shard on its device in ``devices``;
    batch (a tree of tensors) is split along axis 0 into
    ``len(devices)`` blocks, shard s taking block s. State: (params,
    residual (n_shards, nvec) fp32 on ``devices[0]``). Returns
    step(state, batch) -> (state, mean loss) with the new params and the
    mean loss on ``devices[0]``; ``step.init_residual(params)`` is the
    zero residual.
    """
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def step(state, batch):
        params, residual = state
        blocks = [torch.chunk(x, n, dim=0) for _, x in tree_flatten(batch)]
        gvecs, losses = [], []
        for s, dev in enumerate(devices):
            leaves = [x.detach().to(dev).requires_grad_()
                      for _, x in tree_flatten(params)]
            local = tree_unflatten(params, leaves)
            loss = loss_fn(local, tree_unflatten(
                batch, [b[s].to(dev) for b in blocks]))
            grads = torch.autograd.grad(loss, leaves)
            gvec, _ = tree_to_vec(tree_unflatten(params, list(grads)))
            if error_feedback:
                gvec = gvec + residual[s].to(dev)
            gvecs.append(gvec)
            losses.append(loss.detach().to(devices[0]))
        gmean, residuals = compressed_dp_mean(gvecs)
        pvec, pmeta = tree_to_vec(params)
        new_params = vec_to_tree(pvec.to(devices[0]) - lr * gmean, pmeta)
        new_res = torch.stack([r.to(devices[0]) for r in residuals])
        return (new_params, new_res), sum(losses[1:], losses[0]) / float(n)

    def init_residual(params):
        nvec = sum(x.numel() for _, x in tree_flatten(params))
        return torch.zeros((n, nvec), dtype=torch.float32, device=devices[0])

    step.init_residual = init_residual
    return step
