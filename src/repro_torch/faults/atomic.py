"""One crash-safe write path for every persisted artifact.

``atomic_write`` is tmp file + flush + fsync + ``os.replace`` +
directory fsync: a crash at ANY instant leaves the destination either
the complete old content or the complete new content, never a torn
file. Every manifest, segment npz, legacy monolithic npz, and family
forest write of the port goes through here (a copy of
``repro/faults/atomic.py``) — there is exactly one place where the
durability discipline lives (and exactly one fault site,
``store.write``, where the chaos plan can attack it).

The ``torn`` fault kind is the attack this helper exists to make
impossible: when the installed :class:`~repro_torch.faults.plan.FaultPlan`
scripts a torn write for this call, the helper deliberately regresses to
the non-atomic behaviour — partial bytes straight onto the destination
path, then a crash (:class:`InjectedFault`) — manufacturing exactly the
on-disk damage that ``load(..., recover=True)`` must quarantine. Torn
injection is the only way this module ever writes non-atomically.
"""
from __future__ import annotations

import io
import os

from .plan import InjectedFault, active_plan, fault_point


def atomic_write(path: str | os.PathLike, writer, *,
                 site: str = "store.write") -> None:
    """Write a file atomically: ``writer(fh)`` produces the full content
    into a binary file object; the destination is replaced only after
    the bytes are on disk (fsync), and the containing directory entry is
    fsynced so the rename itself survives a crash."""
    path = os.fspath(path)
    spec = fault_point(site, path=path)
    if spec is not None and spec.kind == "torn":
        # scripted torn write: the non-atomic writer of old, resurrected
        # for recovery testing — frac of the payload lands directly on
        # the destination, then the "process dies"
        buf = io.BytesIO()
        writer(buf)
        data = buf.getvalue()
        with open(path, "wb") as fh:
            fh.write(data[:max(1, int(len(data) * spec.frac))])
        plan = active_plan()
        raise InjectedFault(site, plan.calls(site) if plan else 0,
                            kind="torn")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            writer(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    _fsync_dir(os.path.dirname(path) or ".")


def _fsync_dir(dirpath: str) -> None:
    """fsync a directory so a completed rename is durable; best-effort on
    platforms/filesystems that refuse directory fds."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
