"""Logical-axis sharding rules and the port's meshes: the port of
``repro/models/sharding.py``.

Physical mesh axes: ("pod", "data", "model") multi-pod, ("data", "model")
single-pod. Logical axes used by the model code:

  batch   -> ("pod", "data")   pure DP (pods are extra DP)
  embed   -> "data"            FSDP / ZeRO-3: params sharded on d_model over
                               the data axis; each entry of a DP row
                               gathers its "model" box of one layer's
                               params at a time
  heads   -> "model"           attention heads (iff divisible)
  kv      -> "model" iff n_kv_heads % model == 0 else replicated
  mlp     -> "model"           the FFN hidden dim
  experts -> "model"           experts
  vocab   -> "model"           embedding / lm_head rows (iff divisible)
  seq     -> None              (sequence kept whole; the KV cache of
                               long-context decode shards seq on "model")

The reference's mesh is a ``jax.sharding.Mesh``; the port's is
:class:`Mesh`, one process over an n-d grid of **mesh entries**, each a
torch device, repeats allowed: ``["cuda:0"] * 4`` as (2, 2) is how one
card runs a 4-entry mesh, ``"cpu"`` repeated is how the tests run it and
``"meta"`` how the dry run does. A spec is the reference's
``PartitionSpec`` as a plain tuple (an axis name, a tuple of names or
None per dim), so ``tuple(P(...))`` compares with it directly. A
:class:`Sharded` tensor holds one block per entry, the slice its spec
gives that entry, on that entry's device; entries that the spec
replicates hold equal copies. Every move between two entries goes
through :meth:`Mesh.move`, tagged with its collective, so the counting
walker (``launch/hlo_walk.py``) sees a mesh's traffic even when every
entry is the same device.

How the port computes over a mesh, against the reference's GSPMD:

* DP: the global batch splits over the DP axes; each DP row computes its
  slice (a batch the DP size does not divide is replicated, and one row
  computes it). FSDP: parameters, masters and moments live as blocks by
  :func:`param_spec_tree`; each entry of a row gathers over "data" its
  own "model" box of one layer's parameters at a time
  (:func:`model_box`), and the gradient of that box goes back to the
  blocks' fp32 buffers (a reduce-scatter summed over the rows).
* Tensor parallelism over "model": entry j of a row (its "model"
  coordinate) computes its slice of each sublayer from its box of the
  weights, as GSPMD splits the reference's matmuls: attention by heads
  (the columns of ``wq``, the rows of ``wo_attn``; its kv heads, or,
  when the "kv" rule replicates them, the one kv head its q heads map
  to under GQA), the MLP by its hidden columns, MoE by experts (the
  router's logits all-gathered, the routing computed alike on every
  entry), and, where ``vocab_ok``, the embedding rows and the head's
  columns (the CE's logsumexp split over the entries). Every entry
  holds the residual, and the entries' partial outputs are all-reduced
  into it as a ring does (a reduce-scatter, then an all-gather; a
  move's gradient is counted going back). No sublayer runs whole: where
  "model" does not divide the heads (qwen2-vl's 28, recurrentgemma's
  10), attention splits them unevenly (:func:`split_units`: the first
  H mod m entries take one head more), each entry reading the kv heads
  its q heads use; the RG-LRU splits by channel blocks of the
  recurrence width (the conv output all-gathered for the gates), the
  mLSTM and sLSTM by head, or, where the entries outnumber the heads,
  by blocks of a head's value columns (:func:`head_shares`; the sLSTM's
  per-step h all-gathered within the head). The rules stay the
  reference's: an entry reads its region of a leaf they keep whole over
  "model". The sequence-parallel decode
  (``layers.seq_sharded_decode_attention``, the reference's one
  explicit ``shard_map`` in the LM) all-gathers q's heads first.
* ``constrain`` has no counterpart: eager torch propagates no sharding,
  and the port places every tensor explicitly.

Archs whose n_heads is not divisible by the model axis (qwen2-vl 28H,
recurrentgemma 10H) replicate attention's weights over "model" and shard
the MLP's; the compute splits all the same (above).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from dataclasses import dataclass

import torch

from ..util import resolve_device

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# callbacks (kind, nbytes) of every move between two entries; process-wide,
# since autograd runs the backward's moves on a thread of its own
_LISTENERS: list = []
_LISTENERS_LOCK = threading.Lock()


@contextlib.contextmanager
def listen(callback):
    """Call ``callback(kind, nbytes)`` for every move between two mesh
    entries made inside the block."""
    with _LISTENERS_LOCK:
        _LISTENERS.append(callback)
    try:
        yield callback
    finally:
        with _LISTENERS_LOCK:
            _LISTENERS.remove(callback)


class Mesh:
    """An n-d grid of mesh entries, each a torch device (repeats allowed),
    with named axes. ``devices``: one device for every entry in row-major
    order, or one device for all; by default the card (raises without
    one)."""

    def __init__(self, shape, axis_names, devices=None):
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        n = math.prod(shape)
        if devices is None or isinstance(devices, (str, torch.device)):
            devices = [resolve_device(devices)] * n
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a {shape} mesh")
        if any(d.type == "cuda" for d in devices):
            resolve_device("cuda")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = tuple(devices)
        self.coords = list(itertools.product(*(range(s) for s in shape)))
        self.walked = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return (f"Mesh({self.shape}, devices "
                f"{sorted({str(d) for d in self.devices})})")

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    @contextlib.contextmanager
    def walk(self, entries):
        """Inside the block only ``entries`` compute (a dry run's one
        entry): the moves to or from the others are counted, not made
        (:meth:`move`)."""
        prev, self.walked = self.walked, tuple(entries)
        try:
            yield self
        finally:
            self.walked = prev

    def computes(self, entry: int) -> bool:
        """Whether ``entry`` computes: every entry does, but inside
        :meth:`walk` only the walked ones."""
        return self.walked is None or entry in self.walked

    def computing(self, entries) -> tuple:
        """Those of ``entries`` that compute."""
        return tuple(e for e in entries if self.computes(e))

    def move(self, t: torch.Tensor, src: int, dst: int, kind: str,
             out: torch.Tensor | None = None) -> torch.Tensor:
        """``t`` from entry ``src`` to entry ``dst`` (into ``out`` when
        given, else a tensor on ``dst``'s device; the same tensor when the
        entries share a device and no gradient flows). A move between two
        entries reports its bytes, tagged ``kind``, to the listeners,
        whatever their devices; under autograd so does its gradient's
        move back (:data:`BACKWARD`). Inside :meth:`walk`, a move to or
        from an entry that does not compute is counted and not made:
        ``t`` stands in for the moved tensor (only its shape matters
        there)."""
        n = _nbytes(t)
        self.count(kind, n, src, dst)
        if out is not None:
            return out.copy_(t)
        if not (self.computes(src) and self.computes(dst)):
            return self._counted(t, [(kind, dst, src, n)])
        if src != dst and t.requires_grad and torch.is_grad_enabled():
            return _Move.apply(t, self, src, dst, kind)
        return t.to(self.devices[dst])

    def spread(self, t: torch.Tensor, src: int, dsts, kind: str,
               piece=None) -> dict:
        """``t``, or its ``piece(t, dst)``, moved from ``src`` to each
        entry of ``dsts``: {dst: tensor on it} for those that compute.
        Inside :meth:`walk` the moves to the others are counted, and so,
        through ``t``, are their gradients' way back."""
        back = []
        for d in dsts:
            if not self.computes(d) and d != src:
                n = _nbytes(t if piece is None else piece(t, d))
                self.count(kind, n, src, d)
                back.append((kind, d, src, n))
        t = self._counted(t, back)
        return {d: self.move(t if piece is None else piece(t, d), src, d,
                             kind) for d in self.computing(dsts)}

    def gather(self, parts: dict, srcs, dst: int, kind: str,
               stand_in=None) -> list:
        """The tensors of entries ``srcs`` on ``dst``, in order, from
        ``parts`` (entry -> tensor, for those that computed one). Inside
        :meth:`walk`, ``stand_in(e, own)`` (default ``dst``'s own
        tensor) stands in for another entry's."""
        return [self.move(parts[e] if e in parts else parts[dst]
                          if stand_in is None else stand_in(e, parts[dst]),
                          e, dst, kind) for e in srcs]

    def all_gather(self, parts: dict, entries, kind: str,
                   piece=None, stand_in=None) -> dict:
        """Each entry's tensor in ``parts`` (or its ``piece(t, dst)``) on
        every computing entry of ``entries``: {dst: [tensors in entries'
        order]}. Inside :meth:`walk` ``stand_in(e, own)`` (default a
        dst's own) stands in for a tensor that was not computed."""
        got = {e: self.spread(t, e, entries, kind, piece)
               for e, t in parts.items()}
        return {d: [got[e][d] if e in got else self.move(
            got[d][d] if stand_in is None else stand_in(e, got[d][d]), e,
            d, kind) for e in entries] for d in self.computing(entries)}

    def _counted(self, t: torch.Tensor, moves) -> torch.Tensor:
        """``t``, whose gradient under autograd counts the way back of
        ``moves`` ``(kind, src, dst, nbytes)``, made forward from dst to
        src: moves a walk counted but did not make."""
        if not moves or not (t.requires_grad and torch.is_grad_enabled()):
            return t
        return _Counted.apply(t, self, tuple(
            (BACKWARD.get(k, k), s, d, n) for k, s, d, n in moves))

    @staticmethod
    def count(kind: str, nbytes: int, src: int, dst: int) -> None:
        """Report a move of ``nbytes`` from entry ``src`` to ``dst`` (none
        when they are one entry). ``move`` and ``spread`` report through
        it."""
        if kind not in COLLECTIVES:
            raise ValueError(kind)
        if src != dst:
            for cb in list(_LISTENERS):
                cb(kind, nbytes)

    def rows(self, axes, batch: int) -> list:
        """The DP rows over the DP ``axes`` for a global batch: each row's
        entries (its coordinates on the other axes in order) and its slice
        of the batch — all of it on every row when the batch does not
        divide the DP size (the reference then replicates it)."""
        axes = tuple(a for a in axes if a in self.shape)
        n_dp = math.prod(self.shape[a] for a in axes)
        idx = [self.axis_names.index(a) for a in axes]
        groups: dict = {}
        for e, c in enumerate(self.coords):
            groups.setdefault(tuple(c[i] for i in idx), []).append(e)
        split = batch % n_dp == 0
        per = batch // n_dp if split else batch
        out = []
        for r, (key, entries) in enumerate(sorted(groups.items())):
            lo = r * per if split else 0
            out.append(Row(r, tuple(entries), self.devices[entries[0]],
                           lo, per))
        return out


# the collective that carries a move's gradient back
BACKWARD = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Move(torch.autograd.Function):
    """A move between two entries under autograd: its gradient moves back,
    counted as :data:`BACKWARD` of its kind."""

    @staticmethod
    def forward(ctx, t, mesh, src, dst, kind):
        ctx.mesh, ctx.src, ctx.dst, ctx.kind = mesh, src, dst, kind
        ctx.device = t.device
        out = t.to(mesh.devices[dst])
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        ctx.mesh.count(BACKWARD.get(ctx.kind, ctx.kind), _nbytes(g),
                       ctx.dst, ctx.src)
        return g.to(ctx.device), None, None, None, None


class _Counted(torch.autograd.Function):
    """The identity, whose backward counts ``moves`` of its gradient."""

    @staticmethod
    def forward(ctx, t, mesh, moves):
        ctx.mesh, ctx.moves = mesh, moves
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        for kind, src, dst, nbytes in ctx.moves:
            ctx.mesh.count(kind, nbytes, src, dst)
        return g, None, None


def stand_in_like(own: torch.Tensor, shape) -> torch.Tensor:
    """Inside :meth:`Mesh.walk`, zeros of ``shape`` for another entry's
    piece, in the graph when ``own`` is (so that its gradient's way back
    is counted too)."""
    t = own.new_zeros(shape)
    if own.requires_grad and torch.is_grad_enabled():
        t.requires_grad_(True)
    return t


def split_units(n: int, m: int) -> list:
    """``n`` units (heads, channels, columns) over ``m`` parts in order:
    part j's [lo, hi), the first ``n mod m`` parts taking one more."""
    q, r = divmod(n, m)
    out, lo = [], 0
    for j in range(m):
        out.append((lo, lo + q + (j < r)))
        lo = out[-1][1]
    return out


def head_shares(n_heads: int, hd: int, m: int) -> list:
    """Each of ``m`` entries' share of a recurrent mixer's heads, as
    (first head, end head, first column, end column) — the columns
    within each of its heads: whole heads by :func:`split_units` where
    the entries do not outnumber the heads, else each head shared by a
    run of entries (:func:`split_units` of the entries over the heads)
    that split its ``hd`` value columns."""
    if m <= n_heads:
        return [(a, b, 0, hd) for a, b in split_units(n_heads, m)]
    out = []
    for h, (lo, hi) in enumerate(split_units(m, n_heads)):
        out += [(h, h + 1, c0, c1) for c0, c1 in split_units(hd, hi - lo)]
    return out


@dataclass(frozen=True)
class Row:
    """One DP row: its index, its entries in "model" order (the first is
    the row's home: it reads the row's inputs and merges the
    sequence-parallel decode), that entry's device, and the rows
    [start, start + size) of the batch."""
    index: int
    entries: tuple
    device: torch.device
    start: int
    size: int

    @property
    def home(self) -> int:
        return self.entries[0]


# ------------------------------------------------------------ specs
def _names(item) -> tuple:
    if item is None:
        return ()
    return tuple(item) if isinstance(item, (tuple, list)) else (item,)


def check_spec(spec, shape, mesh: Mesh) -> None:
    """Raise where ``NamedSharding`` would: a spec longer than the array,
    an axis the mesh lacks or used twice, or a dim that its axes do not
    divide."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape {shape}")
    used = [a for item in spec for a in _names(item)]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} uses a mesh axis twice")
    for a in used:
        if a not in mesh.shape:
            raise ValueError(f"spec {spec}: mesh has no axis {a!r}")
    for d, item in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _names(item))
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"into {n} for spec {spec}")


def block_box(shape, spec, mesh: Mesh, entry: int) -> tuple:
    """The (lo, hi) range per dim that ``spec`` gives ``entry``. A dim
    split over several axes is indexed row-major over them, first axis
    major, as ``NamedSharding`` does."""
    c = dict(zip(mesh.axis_names, mesh.coords[entry]))
    box = []
    for d, size in enumerate(shape):
        item = spec[d] if d < len(spec) else None
        idx, n = 0, 1
        for a in _names(item):
            idx = idx * mesh.shape[a] + c[a]
            n *= mesh.shape[a]
        step = size // n
        box.append((idx * step, (idx + 1) * step))
    return tuple(box)


def model_box(shape, spec, mesh: Mesh, entry: int) -> tuple:
    """``entry``'s box of a leaf for its tensor-parallel slice: the part
    of :func:`block_box` that "model" gives it, whole over every other
    axis (what the entry reads, gathered over "data")."""
    only = tuple("model" if "model" in _names(item) else None
                 for item in spec)
    return block_box(shape, only, mesh, entry)


def shard_shape(shape, spec, mesh: Mesh) -> tuple:
    """Every entry's block shape (``NamedSharding.shard_shape``)."""
    check_spec(spec, shape, mesh)
    return tuple(hi - lo for lo, hi in block_box(shape, spec, mesh, 0))


def _overlap(a, b):
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _index(box, origin):
    return tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(box, origin))


def _assemble(pieces: dict, dim: int) -> torch.Tensor:
    """One tensor from pieces keyed by their lower corner that tile a box:
    grouped by their start on ``dim``, each group assembled over the
    later dims, the groups concatenated along ``dim`` (a cat per group,
    not a copy per piece)."""
    if len(pieces) == 1:
        return next(iter(pieces.values()))
    groups: dict = {}
    for lo, t in pieces.items():
        groups.setdefault(lo[dim], {})[lo] = t
    if len(groups) == 1:
        return _assemble(pieces, dim + 1)
    return torch.cat([_assemble(groups[k], dim + 1) for k in sorted(groups)],
                     dim=dim)


class Sharded:
    """A tensor of global ``shape`` held as one block per mesh entry by
    ``spec`` (see the module docstring)."""

    def __init__(self, mesh: Mesh, spec, blocks, shape, dtype):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.blocks = list(blocks)
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.boxes = [block_box(self.shape, self.spec, mesh, e)
                      for e in range(mesh.size)]
        self.holders: dict = {}       # each distinct box -> its entries
        for e, box in enumerate(self.boxes):
            self.holders.setdefault(box, []).append(e)

    # -------------------------------------------------------- building
    @classmethod
    def place(cls, x: torch.Tensor, mesh: Mesh, spec) -> "Sharded":
        """``x`` cut into its blocks, each copied onto its entry's device:
        entries on one device get separate storage."""
        spec = tuple(spec)
        check_spec(spec, x.shape, mesh)
        blocks = []
        for e, dev in enumerate(mesh.devices):
            box = block_box(x.shape, spec, mesh, e)
            blk = x.detach()[tuple(slice(lo, hi) for lo, hi in box)]
            blocks.append(blk.to(dev, copy=True))
        return cls(mesh, spec, blocks, x.shape, x.dtype)

    @classmethod
    def empty(cls, shape, dtype, mesh: Mesh, spec, fill=None,
              entries=None) -> "Sharded":
        """Uninitialised blocks (or all ``fill``) on every entry, or only
        on ``entries`` (the others None: a dry run's one device)."""
        spec = tuple(spec)
        bs = shard_shape(shape, spec, mesh)
        blocks = [None if entries is not None and e not in entries
                  else torch.empty(bs, dtype=dtype, device=d) if fill is None
                  else torch.full(bs, fill, dtype=dtype, device=d)
                  for e, d in enumerate(mesh.devices)]
        return cls(mesh, spec, blocks, shape, dtype)

    def like(self, dtype=None, fill=None) -> "Sharded":
        return Sharded.empty(self.shape, dtype or self.dtype, self.mesh,
                             self.spec, fill)

    # -------------------------------------------------------- reading
    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.dtype.itemsize

    def block_numel(self, entry: int) -> int:
        return math.prod(hi - lo for lo, hi in self.boxes[entry])

    def block_nbytes(self, entry: int) -> int:
        return self.block_numel(entry) * self.element_size()

    def distinct(self) -> list:
        """One entry per distinct block (the first that holds it)."""
        return [es[0] for es in self.holders.values()]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first entry's),
        from the distinct blocks. A read out of the mesh (a host copy, a
        check), not a move between entries: it reports nothing."""
        dev = torch.device(device) if device is not None \
            else self.mesh.devices[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for e in self.distinct():
            out[_index(self.boxes[e], (0,) * self.ndim)].copy_(self.blocks[e])
        return out

    def _holder(self, box, dst: int, prefer):
        """The entry to read from the distinct block ``box``: ``dst``
        itself, else one of ``prefer``, else the one whose coordinates
        differ least from ``dst``'s."""
        holders = self.holders[box]
        if dst in holders:
            return dst
        pref = [e for e in holders if e in prefer]
        if pref:
            return pref[0]
        cd = self.mesh.coords[dst]
        return min(holders, key=lambda e: (sum(
            a != b for a, b in zip(self.mesh.coords[e], cd)), e))

    def read(self, entry: int, region=None, kind: str = "all-gather",
             prefer=()) -> torch.Tensor:
        """The ``region`` (a (lo, hi) per dim; default the whole tensor)
        on ``entry``'s device, assembled from the blocks that cover it —
        the entry's own where it holds them. Pieces from other entries
        are moves tagged ``kind``. A region inside the entry's own block
        comes back as a view of it."""
        region = tuple(region) if region is not None else tuple(
            (0, n) for n in self.shape)
        own = _overlap(self.boxes[entry], region)
        if own == region:
            return self.blocks[entry][_index(region, [lo for lo, _ in
                                                      self.boxes[entry]])]
        pieces = []
        for box in self.holders:
            ov = _overlap(box, region)
            if ov is not None:
                pieces.append((box, ov))
        moved = {}
        for box, ov in pieces:
            src = self._holder(box, entry, prefer)
            blk = self.blocks[src][_index(ov, [lo for lo, _ in box])]
            moved[tuple(lo for lo, _ in ov)] = self.mesh.move(blk, src, entry,
                                                             kind)
        return _assemble(moved, 0)

    def write(self, t: torch.Tensor, src: int, region=None, entries=None,
              kind: str = "collective-permute") -> None:
        """Write ``t`` (the value of ``region`` on entry ``src``) into every
        block that overlaps the region, among ``entries`` (default all):
        replicas get the same values."""
        region = tuple(region) if region is not None else tuple(
            (0, n) for n in self.shape)
        origin = [lo for lo, _ in region]
        for e in (range(self.mesh.size) if entries is None else entries):
            ov = _overlap(self.boxes[e], region)
            if ov is None:
                continue
            dst = self.blocks[e][_index(ov, [lo for lo, _ in self.boxes[e]])]
            self.mesh.move(t[_index(ov, origin)], src, e, kind, out=dst)

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec}, {self.mesh})")


# ------------------------------------------------------------ rules
def dp_axes(mesh: Mesh) -> tuple:
    """The DP axes: ("pod", "data") on a multi-pod mesh, else ("data",)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_rules(cfg, mesh: Mesh, *, fsdp: bool = True) -> dict:
    """Resolve logical axes -> physical axes for this (config, mesh), as
    the reference does.

    fsdp=False selects ZeRO-1: compute params replicate over "data";
    the optimizer state keeps the FSDP split (``launch/dryrun.py``'s
    ``--zero1``).
    """
    model = mesh.axis_size("model")
    dp = dp_axes(mesh)
    heads_ok = cfg.n_heads % model == 0
    kv_ok = cfg.n_kv_heads % model == 0
    # an even tiling is required (as NamedSharding requires it): a vocab
    # that "model" does not divide (granite-3-8b's 49,155) stays
    # replicated over "model" and FSDP-sharded on the embed dim
    vocab_ok = cfg.vocab_size % model == 0
    return {
        "batch": dp,
        "embed": "data" if fsdp else None,
        "heads": "model" if heads_ok else None,
        "kv": "model" if (heads_ok and kv_ok) else None,
        "mlp": "model",
        "experts": "model",
        "vocab": "model" if vocab_ok else None,
        "seq": None,
        "kv_seq": "model",   # long-context decode: the KV cache on seq
        "_mesh": mesh,       # carried for the seq-parallel decode; not a
                             # logical axis
    }


def _item(axes):
    """A spec item as ``PartitionSpec`` keeps it: a one-name tuple is the
    name."""
    if isinstance(axes, (tuple, list)):
        return axes[0] if len(axes) == 1 else tuple(axes)
    return axes


def logical(spec, rules) -> tuple:
    """Translate a logical spec tuple to a physical spec tuple."""
    return tuple(_item(rules.get(a)) if a is not None else None
                 for a in spec)


def _leaf_spec(name: str, nd: int, dim0: int, rules) -> tuple:
    """The reference's spec of a leaf by its last path part, for a leaf
    of ``nd`` dims (without any stack axis) whose first dim is ``dim0``."""
    mesh = rules.get("_mesh")
    L = lambda *axes: logical(axes, rules)     # noqa: E731
    if name == "embedding":
        return L("vocab", "embed")
    if name == "lm_head":
        return L("embed", "vocab")
    if name == "wq":
        return L("embed", "heads")
    if name == "wo_attn":
        return L("heads", "embed")
    if name in ("wk", "wv"):
        return L("embed", "kv")
    if name in ("wi", "wg"):
        return L("embed", "mlp")
    if name == "wo":
        return L("mlp", "embed")
    if name == "router":
        return L("embed", "experts")
    if name in ("ewi", "ewg"):      # (E, d, ff)
        return L("experts", "embed", None)
    if name == "ewo":               # (E, ff, d)
        return L("experts", None, "embed")
    if name in ("w_in", "w_gate"):  # rglru up-projections (d, dr)
        return L("embed", "mlp")
    if name == "conv_w":            # (conv_width, dr)
        return L(None, "mlp")
    # recurrent / misc matrices: FSDP on dim0 when it divides "data"
    if nd == 2:
        data_n = mesh.axis_size("data") if mesh is not None else 1
        return L("embed" if dim0 % max(data_n, 1) == 0 else None, None)
    return (None,) * nd


def _named_leaves(model_or_params):
    if isinstance(model_or_params, dict):
        return list(model_or_params.items())
    return list(model_or_params.named_parameters())


def param_spec_tree(model_or_params, cfg, rules) -> dict:
    """The spec of every parameter by the port's name (an ``LM``, a
    ``ShardedLM`` or a dict name -> tensor). A name whose reference leaf
    is a stacked ``blocks/...`` leaf gets the reference's spec without its
    leading None; the dim0 fallback reads the dim after the stack axis,
    as the reference does."""
    from .model import reference_key
    out = {}
    for name, leaf in _named_leaves(model_or_params):
        path, _g = reference_key(cfg, name)
        out[name] = _leaf_spec(path[-1], len(leaf.shape), leaf.shape[0],
                               rules)
    return out


def shard_params(model, cfg, mesh: Mesh, rules=None) -> dict:
    """Each parameter of ``model`` as a :class:`Sharded` on ``mesh`` by
    :func:`param_spec_tree` (``rules`` default: ``make_rules(cfg, mesh)``),
    in the model's order."""
    rules = rules if rules is not None else make_rules(cfg, mesh)
    specs = param_spec_tree(model, cfg, rules)
    return {n: Sharded.place(p, mesh, specs[n])
            for n, p in _named_leaves(model)}


def cache_spec_tree(cache, cfg, rules) -> list:
    """The spec of every leaf of a decode cache (``init_cache``'s list per
    layer), in its structure.

    Global-attention KV caches shard their SEQUENCE axis on "model"
    (sequence-parallel decode); ring (windowed) caches and recurrent
    states stay batch-sharded only. Batch goes on the DP axes when it
    divides them, else it is replicated (long_500k has batch 1).
    """
    from .model import layer_kind
    mesh = rules["_mesh"]
    n_model = mesh.axis_size("model")
    batch_axes = _names(rules["batch"])
    dp_total = math.prod(mesh.axis_size(a) for a in batch_axes)

    def spec_for(kind, name, leaf):
        nd = leaf.ndim
        if kind in ("attn", "local_attn"):
            is_ring = kind == "local_attn" and cfg.window
            if name in ("k", "v"):
                B, Smax = leaf.shape[0], leaf.shape[1]
                b = _item(rules["batch"]) if B % dp_total == 0 else None
                s = "model" if (not is_ring and Smax % n_model == 0) else None
                return (b, s, None, None)
            if name == "pos":
                Smax = leaf.shape[0]
                s = "model" if (not is_ring and Smax % n_model == 0) else None
                return (s,)
        B = leaf.shape[0] if nd >= 1 else 1
        b = _item(rules["batch"]) if (nd >= 1 and B % dp_total == 0) \
            else None
        return (b, *([None] * (nd - 1)))

    out = []
    for i, c in enumerate(cache):
        kind = layer_kind(cfg, i)
        if isinstance(c, dict):
            out.append({k: spec_for(kind, k, v) for k, v in c.items()})
        else:
            out.append(type(c)(spec_for(kind, str(j), v)
                               for j, v in enumerate(c)))
    return out


def shard_cache(cache, cfg, rules) -> list:
    """The cache's leaves as :class:`Sharded` by :func:`cache_spec_tree`."""
    mesh = rules["_mesh"]
    specs = cache_spec_tree(cache, cfg, rules)
    out = []
    for c, s in zip(cache, specs):
        if isinstance(c, dict):
            out.append({k: Sharded.place(v, mesh, s[k]) for k, v in c.items()})
        else:
            out.append(type(c)(Sharded.place(v, mesh, sv)
                               for v, sv in zip(c, s)))
    return out
