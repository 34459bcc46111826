"""Checkpoint manager: the port of ``repro/checkpoint/manager.py``, with
the reference's on-disk format, so a checkpoint the JAX package wrote
loads here.

  * one ``leaf_%05d.npy`` per tree leaf + ``manifest.json`` holding
    ``step`` and, per leaf, its ``path`` (keys joined by "/"), ``file``,
    ``shape`` and logical ``dtype``; numpy's .npy has no bfloat16 or
    float8, so those are stored as their uint16 / uint8 bits and carried
    back by torch views (no ``ml_dtypes``);
  * ATOMIC: a step is written into ``step_%08d.tmp/`` — every file
    through ``faults.atomic.atomic_write`` (fsync'd) — then renamed to
    ``step_%08d/`` and the directory fsync'd. A crash mid-write never
    corrupts the latest checkpoint; restore picks the newest *complete*
    step directory;
  * ASYNC: ``save(..., block=False)`` hands the host copy to a writer
    thread. The device->host copy happens inside ``save`` (the state is
    updated in place by the next step); only disk I/O is deferred. A
    failed write is raised by the next ``wait``.

  * ELASTIC: ``restore(sharding_tree=...)`` places each leaf by a
    (mesh, spec) on a NEW mesh — a job restarted at another scale
    resumes from the same manifest.

Trees are nested dicts, lists and tuples of tensors or ``Sharded``
tensors; ``save`` writes a ``Sharded`` leaf's whole array, as the
reference does in one process (the format does not change). ``restore``
puts each leaf on the device and in the dtype of the matching leaf of
``like``, or places it by ``sharding_tree``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..faults.atomic import _fsync_dir, atomic_write
from ..models.sharding import Sharded
from ..util import tree_flatten, tree_unflatten

# logical dtype -> the same-width integer dtype its bits are stored as
_BITCAST = {"bfloat16": (torch.int16, np.uint16),
            "float8_e4m3fn": (torch.uint8, np.uint8),
            "float8_e5m2": (torch.uint8, np.uint8)}


def _to_savable(t) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (a tensor or a ``Sharded`` one, whole) as a
    numpy array, and its logical dtype."""
    name = str(t.dtype).removeprefix("torch.")
    t = t.full("cpu") if isinstance(t, Sharded) else \
        t.detach().to("cpu", copy=True)
    if name in _BITCAST:
        tview, npdt = _BITCAST[name]
        return t.view(tview).numpy().view(npdt), name
    return t.numpy(), name


def _from_savable(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _BITCAST:
        tview, _ = _BITCAST[logical]
        return torch.from_numpy(arr.view(np.dtype(str(tview).removeprefix(
            "torch.")))).view(getattr(torch, logical))
    return torch.from_numpy(arr)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3,
                 async_writes: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._q: queue.Queue | None = None
        self._error: BaseException | None = None
        if async_writes:
            self._q = queue.Queue(maxsize=2)
            threading.Thread(target=self._writer_loop, daemon=True).start()

    # ------------------------------------------------------------ save
    def save(self, step: int, state, *, block: bool = True):
        """Snapshot ``state`` (a tree of tensors) at ``step``."""
        host = [(_path_str(p), *_to_savable(
            leaf if isinstance(leaf, Sharded) else torch.as_tensor(leaf)))
                for p, leaf in tree_flatten(state)]
        if self._q is not None and not block:
            self._q.put((step, host))
        else:
            self._write(step, host)

    def _writer_loop(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:     # raised again by wait()
                self._error = e
            finally:
                self._q.task_done()

    def wait(self):
        """Block until every queued write is on disk; raise the first
        write that failed."""
        if self._q is not None:
            self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: list):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "leaves": []}
        for i, (path, arr, logical) in enumerate(host):
            fn = f"leaf_{i:05d}.npy"
            atomic_write(tmp / fn, lambda fh, a=arr: np.save(fh, a),
                         site="checkpoint.write")
            manifest["leaves"].append({"path": path, "file": fn,
                                       "shape": list(arr.shape),
                                       "dtype": logical})
        atomic_write(tmp / "manifest.json",
                     lambda fh: fh.write(json.dumps(manifest).encode()),
                     site="checkpoint.write")
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        _fsync_dir(str(self.dir))
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------ restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.name.startswith("step_") and not p.name.endswith(".tmp") \
                    and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like=None, step: int | None = None,
                sharding_tree=None):
        """Restore step ``step`` (the latest by default) into the structure
        of ``like`` (a tree of tensors: each leaf lands on its device, in
        its dtype). Without ``like``, the manifest's own tree: nested
        dicts keyed by the path's parts, CPU tensors in the stored dtypes.
        A ``Sharded`` leaf of ``like`` comes back placed as it is.
        ``sharding_tree``: a tree shaped as ``like`` of (mesh, spec)
        pairs (or None for a leaf to restore as above): each such leaf
        comes back ``Sharded`` on that mesh, in ``like``'s dtype — the
        elastic restore onto another mesh. Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)

        def load(ent):
            return _from_savable(np.load(d / ent["file"]), ent["dtype"])

        if like is None:
            tree: dict = {}
            for ent in manifest["leaves"]:
                *parents, last = ent["path"].split("/")
                node = tree
                for k in parents:
                    node = node.setdefault(k, {})
                node[last] = load(ent)
            return tree, step
        by_path = {e["path"]: e for e in manifest["leaves"]}
        flat = tree_flatten(like)
        placements = [None] * len(flat)
        if sharding_tree is not None:
            placements = _placements(like, sharding_tree)
        out = []
        for (path, leaf), sh in zip(flat, placements):
            ent = by_path[_path_str(path)]
            t = load(ent)
            if list(t.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch at {ent['path']}: stored "
                                 f"{list(t.shape)}, expected "
                                 f"{list(leaf.shape)}")
            if sh is None and isinstance(leaf, Sharded):
                sh = (leaf.mesh, leaf.spec)
            if sh is not None:
                out.append(Sharded.place(t.to(leaf.dtype), *sh))
            else:
                out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return tree_unflatten(like, out), step


def _placements(like, sharding_tree) -> list:
    """The (mesh, spec) of each of ``like``'s leaves, in
    ``tree_flatten``'s order, from a tree of the same structure whose
    leaves are (mesh, spec) pairs or None."""
    out = []

    def walk(node, sh):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], None if sh is None else sh[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, None if sh is None else sh[i])
        else:
            out.append(sh)
    walk(like, sharding_tree)
    return out
