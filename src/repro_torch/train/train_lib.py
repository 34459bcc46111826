"""Microbatched training step: the port of ``repro/train/train_lib.py``.

Grad accumulation walks the microbatches one at a time (saved
activations are bounded by one microbatch, as the reference's scan
bounds them), takes each one's grads with ``torch.autograd.grad`` and
adds them into fp32 accumulators — not into ``param.grad``, which would
accumulate in the parameter's dtype (bf16 for the blocks).

The reference's meshes (``mesh=``/``rules=``, ``batch_sharding``) are
not ported yet: ``make_train_step`` and ``init_train_state`` raise when
given one. Gradient compression is, as in the reference, an explicit-DP
feature of ``compression.make_compressed_dp_step``, not of this step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import torch

from ..models.model import (LM, init_params, params_from_reference,
                            reference_leaf, reference_params, train_step_fn,
                            _put)
from ..util import resolve_device
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        reference_decay_mask)


@dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    opt: AdamWConfig = field(default_factory=AdamWConfig)


@dataclass
class TrainState:
    """The model (its parameters are the compute params), the optimizer
    state of :func:`~repro_torch.train.optimizer.adamw_init` and the step,
    an int32 0-d tensor. A train step updates all three in place."""
    model: LM
    opt_state: dict
    step: torch.Tensor

    @property
    def params(self) -> dict:
        """The parameters by name, in the reference's flatten order."""
        return reference_params(self.model)

    @cached_property
    def decay(self) -> dict:
        """Which parameters take weight decay (``reference_decay_mask``):
        it depends on the model alone, so it is built once."""
        return reference_decay_mask(self.model)

    def tree(self) -> dict:
        """The state as a nested dict of tensors (what a checkpoint
        holds): params by name, opt_state, step."""
        return {"params": {n: p.detach() for n, p in self.params.items()},
                "opt_state": self.opt_state, "step": self.step}

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Take the values of a tree shaped as :meth:`tree`'s."""
        self.model.load_state_dict(tree["params"])
        self.opt_state = tree["opt_state"]
        self.step = tree["step"]


def _no_mesh(mesh, rules=None):
    if mesh is not None or rules:
        raise NotImplementedError(
            "meshes and sharding rules are not ported yet: the port's "
            "training step runs on one device")


def init_train_state(generator: torch.Generator, cfg, device=None,
                     mesh=None) -> TrainState:
    """A fresh model from ``generator`` (see ``init_params``) on
    ``device`` (the card by default), its AdamW state and step 0."""
    _no_mesh(mesh)
    model = init_params(cfg, generator, resolve_device(device))
    return TrainState(model=model, opt_state=adamw_init(reference_params(model)),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def train_state_from_reference(tree, cfg, device=None) -> TrainState:
    """The JAX package's ``TrainState`` as the port's: ``tree`` is one with
    numpy leaves (``params``, ``opt_state.{master,mu,nu,step}``, ``step``),
    or the nested dict its checkpoint manifest holds (keys "0", "1" and
    "2" for those three). The (G, ...) stacked leaves of params and of the
    masters and moments are sliced per layer by ``reference_key``."""
    if isinstance(tree, dict):
        params, opt, step = tree["0"], tree["1"], tree["2"]
    else:
        params, opt, step = tree.params, tree.opt_state, tree.step
    model = params_from_reference(params, cfg, device)
    state = TrainState(model=model,
                       opt_state=adamw_init(reference_params(model)),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=model.device))
    with torch.no_grad():
        for key in ("master", "mu", "nu"):
            for name, dst in state.opt_state[key].items():
                _put(dst, reference_leaf(opt[key], cfg, name))
        _put(state.opt_state["step"], opt["step"])
        _put(state.step, step)
    return state


def make_train_step(model_cfg, train_cfg: TrainConfig, mesh=None,
                    rules: dict | None = None):
    """Returns train_step(state, batch) -> (state, metrics dict(loss, aux,
    lr, grad_norm)); the state is updated in place and returned.

    batch: dict(inputs (B, S[, d]), targets (B, S)) on the model's device;
    it is split into ``train_cfg.n_microbatches`` along axis 0. With one
    microbatch the grads stay in the parameters' dtypes; with more, they
    are summed in fp32 and divided by the count, and so are the loss and
    the aux loss.
    """
    _no_mesh(mesh, rules)
    nm = train_cfg.n_microbatches

    def grad_accum(model, batch):
        mbs = {k: v.reshape((nm, v.shape[0] // nm) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        acc = None
        lsum = asum = torch.zeros((), dtype=torch.float32,
                                  device=model.device)
        for i in range(nm):
            loss, metrics, grads = train_step_fn(
                model, {k: v[i] for k, v in mbs.items()})
            if acc is None:
                # the reference adds into fp32 zeros: 0 + g is g, and an
                # fp32 grad is this step's own buffer
                acc = {n: g.float() for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    acc[n] += g
            del grads
            lsum = lsum + loss
            asum = asum + metrics["aux"]
        for g in acc.values():
            g /= nm
        return acc, lsum / nm, asum / nm

    def train_step(state: TrainState, batch: dict):
        if nm > 1:
            grads, loss, aux = grad_accum(state.model, batch)
        else:
            loss, metrics, grads = train_step_fn(state.model, batch)
            aux = metrics["aux"]
        _, state.opt_state, stats = adamw_update(
            grads, state.opt_state, state.params, train_cfg.opt,
            decay=state.decay)
        state.step = state.step + 1
        return state, {"loss": loss, "aux": aux, **stats}

    return train_step
