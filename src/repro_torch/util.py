"""Small shared helpers: power-of-two quantization, device resolution and
grouping, full-precision float32 products, the uint32 <-> int32
bit-pattern conversions, and flattening trees of tensors."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def next_pow2(x: int) -> int:
    """Smallest power of two >= x; 0 stays 0 (callers wanting a nonzero
    floor clamp first)."""
    return 1 << (int(x) - 1).bit_length() if x > 0 else 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when CUDA is asked for and there is no card —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """One spelling per device, for cache keys: ``"cpu"``, ``"cpu:1"`` and
    ``torch.device("cpu")`` are all ``cpu`` (a CPU tensor carries no
    index), and ``"cuda"`` is ``cuda:<current device>``. Without this,
    ``lru_cache`` holds one device under two keys and builds twice."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None and dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def group_devices(devices) -> list:
    """Shards grouped by device, in order of first appearance:
    ``[(device, [shard indices])]``. The shards of one group stack on a
    leading shard axis on their device."""
    groups: dict[torch.device, list[int]] = {}
    for s, d in enumerate(devices):
        groups.setdefault(d, []).append(s)
    return list(groups.items())


@contextlib.contextmanager
def full_float32_matmul():
    """Run float32 products at full float32 precision (no TF32 or bf16
    passes), whatever the caller set, and restore its setting after. The
    port's integer products that run in float32 rely on it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def u32_to_i32(a) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor holding the same bit pattern (a
    view, no copy). Signatures travel as int32 bits: XOR and popcount do
    not care about the sign, and torch's uint32 lacks most operators."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def i32_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> uint32 numpy words (host copy)."""
    return t.detach().cpu().numpy().view(np.uint32)


def as_unsigned(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the unsigned value, the form
    every shift, sort and search of 32-bit words runs on in the port."""
    return t.to(torch.int64) & 0xFFFFFFFF


def tree_flatten(tree) -> list:
    """The leaves of nested dicts, lists and tuples with their key paths,
    ``[(path tuple, leaf)]``, dict keys in sorted order as ``jax.tree``
    flattens them."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))
    walk(tree, ())
    return out


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in
    :func:`tree_flatten`'s order (dicts keep ``like``'s key order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)
