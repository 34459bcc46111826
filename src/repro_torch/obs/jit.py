"""Recompile sentinel: count program builds per cache key, loudly.

The port's copy of ``repro/obs/jit.py``. The reference counts traces of
``jax.jit``-ed bodies; the port has no ``jax.jit``, and its counterpart of
a compiled program is a build that the port caches: a kernel library
loaded once per source (``kernels/build.py::library``), a per-word table
or K1's operands uploaded once per device (``core/simhash.py``), the
BLOSUM62 table of the SW kernels (``kernels/sw.py::_table``).
:func:`trace_sentinel` wraps the body of such a builder *beneath* its
cache, so the body runs once per cache miss and each execution is one
build. The key is the builder's arguments (``(shape, dtype)`` for
tensors, ``repr`` for the rest), which separates the two failure modes:

* a **new key** building once — expected (a new device, a new table);
* the **same key** building twice — a silent rebuild: the cache upstream
  failed to reuse what it already paid for (two spellings of one device,
  ``"cpu"`` and ``torch.device("cpu")`` or ``"cuda"`` and ``"cuda:0"``,
  reaching an ``lru_cache`` as two keys; an evicted entry). ``counts()``
  makes these jump out (``n > 1``); :meth:`CompileSentinel.recompiled`
  lists them.
"""
from __future__ import annotations

import contextlib
import functools
import threading

from .registry import REGISTRY
from .trace import instant

__all__ = ["SENTINEL", "CompileSentinel", "trace_sentinel"]

_compiles = REGISTRY.counter(
    "jit_compiles", "program (re)builds recorded by the recompile "
    "sentinel, by instrumented site", labelnames=("site",))


def _abstract_key(args, kwargs) -> tuple:
    """Stable signature of a build: (shape, dtype) for tensors and arrays,
    repr for everything else. Two builds with equal keys are the *same*
    program being paid for twice."""
    def one(a):
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            return ("arr", tuple(shape), str(dtype))
        return repr(a)
    return (tuple(one(a) for a in args),
            tuple((k, one(v)) for k, v in sorted(kwargs.items())))


class CompileSentinel:
    """Thread-safe build counter keyed by (site, abstract signature)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[tuple, int] = {}

    def record(self, site: str, key: tuple) -> None:
        with self._lock:
            k = (site, key)
            self._counts[k] = self._counts.get(k, 0) + 1
            n = self._counts[k]
        _compiles.inc(site=site)
        instant("compile", cat="jit", site=site, n_for_key=n)

    # ------------------------------------------------------------ read
    def counts(self, site: str | None = None) -> dict:
        """{(site, key): n}; filtered to one site when given."""
        with self._lock:
            items = dict(self._counts)
        if site is None:
            return items
        return {k: v for k, v in items.items() if k[0] == site}

    def total(self, site: str | None = None) -> int:
        return sum(self.counts(site).values())

    def by_site(self) -> dict:
        """{site: total builds} — the summary a run reports."""
        out: dict[str, int] = {}
        for (site, _key), n in self.counts().items():
            out[site] = out.get(site, 0) + n
        return out

    def recompiled(self) -> dict:
        """Keys built MORE than once — each one is a silent-rebuild bug
        (the program was paid for, then paid for again)."""
        return {k: n for k, n in self.counts().items() if n > 1}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    # ------------------------------------------------------------ assert
    @contextlib.contextmanager
    def expect_no_compiles(self, site: str | None = None, *,
                           message: str = ""):
        """Assert that the enclosed block triggers ZERO (re)builds — the
        steady-state invariant a warmed serving path must hold."""
        before = self.counts(site)
        yield
        after = self.counts(site)
        fresh = {k: after[k] - before.get(k, 0)
                 for k in after if after[k] != before.get(k, 0)}
        if fresh:
            rows = "\n".join(f"  {s}: +{n} (key={key!r})"
                             for (s, key), n in sorted(fresh.items()))
            raise AssertionError(
                f"{message or 'steady state violated'}: "
                f"{sum(fresh.values())} compile(s) inside a zero-compile "
                f"region —\n{rows}")


SENTINEL = CompileSentinel()


def trace_sentinel(site: str, static_key: tuple = ()):
    """Decorate the body of a cached builder, placed UNDER its cache, so
    that every build is recorded::

        @functools.lru_cache(maxsize=8)
        @trace_sentinel("sw_table")
        def _build_table(device, sentinel): ...

    ``static_key`` is for bodies whose inputs are captured by closure and
    so invisible in the call arguments: pass the builder's cache key
    through, or a legitimate build for a new key looks identical to a
    silent rebuild of the old one.

    Adds one host-side dict bump per *build*, nothing per cache hit."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            SENTINEL.record(site, _abstract_key(args, kwargs)
                            + (("static", static_key),))
            return fn(*args, **kwargs)
        return inner
    return deco
