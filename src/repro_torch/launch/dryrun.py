"""Multi-pod dry run: size every (arch x shape x mesh) cell on ``meta``
entries — the port of ``repro/launch/dryrun.py``.

For each runnable cell (31 of the 40 — see configs.shape_applicable), the
state is placed on the production mesh's ``meta`` entries by the spec
trees (nothing is allocated), and one mesh entry's share of the step —
the first entry of the first DP row — runs under the counting walker
(``launch/hlo_walk.py``):

  * train_4k    -> the mesh training step's ``dry_row``: that entry's
                   slice of the first row's microbatches and AdamW on
                   its blocks
  * prefill_32k -> its slice of the first row's forward and
                   last-position logits
  * decode_*    -> its slice of the first row's ``decode_step`` against
                   a cache placed by ``cache_spec_tree`` (its part of the
                   sequence-parallel attention)

The entry computes its tensor-parallel slice of every sublayer (heads,
MLP hidden, experts, vocab, the RG-LRU's channels, the mLSTM's and
sLSTM's heads or value columns); the moves the row's other entries make
to it or take from it (the all-reduce of the partials, the all-gathers
of k and v columns, of the RG-LRU's conv output and of the sLSTM's h,
the gradients' reduce-scatter) are counted, not made, inside
``Mesh.walk``. The entries' shares are equal, or, where "model" does not
divide the heads, the first entries' hold one head more: the first
entry is the busiest, so the figures are per device, as the
reference's. Per-device
memory = the placed blocks' bytes on the busiest entry of the row
("argument") plus the walk's peak of live op outputs ("temp");
``row_entries`` in the JSON is the row's size. The roofline terms use the H100's data-sheet
rates (``roofline.py``); results go to
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

Stand-ins on ``meta``: the MoE's sort-based dispatch sizes its buffers by
capacity, not by counts, so it runs unchanged (its routing is made of
meta values); the sequence-parallel decode writes its slot with a
device-side select, so no position is read on the host.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]
"""
import argparse
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..models.config import active_param_count
from ..models.model import (LM, ShardedLM, _logits, decode_step, init_cache,
                            reference_params)
from ..models.sharding import Sharded, dp_axes, make_rules
from ..train import AdamWConfig, TrainConfig, make_train_step
from ..train.optimizer import adamw_init
from ..train.train_lib import TrainState, shard_train_state
from .hlo_walk import walk
from .mesh import chips, dp_size, input_specs, make_production_mesh
from .roofline import analyze, model_flops_for, save_json

# Per-arch microbatch counts for train_4k (the reference's, sized so saved
# residuals fit at batch 256 / 16-way DP).
TRAIN_MICROBATCHES = {
    "olmoe-1b-7b": 4, "qwen3-moe-30b-a3b": 8, "hubert-xlarge": 4,
    "recurrentgemma-2b": 8, "qwen2-vl-7b": 16, "nemotron-4-15b": 8,
    "granite-3-8b": 8, "granite-34b": 16, "yi-9b": 8, "xlstm-1.3b": 8,
}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, Sharded):
        yield tree


def argument_bytes(tree, entries) -> int:
    """The placed blocks' bytes on the busiest of ``entries``."""
    leaves = list(_leaves(tree))
    return max(sum(s.block_nbytes(e) for s in leaves) for e in entries)


def _placed_inputs(io, mesh):
    return {k: Sharded.place(t, mesh, spec) if spec is not None else t
            for k, (t, spec) in io.items()}


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               *, zero1: bool = False, causal_skip: bool = False,
               cfg=None):
    """Place one cell on ``mesh`` (its entries ``meta``, or any devices)
    and walk one entry's share of the step; returns (memory dict,
    roofline).

    zero1=True: compute params whole over "data" (no per-microbatch FSDP
    regather), optimizer state FSDP-split. causal_skip=True: the
    triangular attention schedule. ``cfg`` overrides the arch's config,
    and ``shape_name`` may be a dict shaped as a ``SHAPES`` entry with a
    "name" (a smoke-sized cell)."""
    cfg = cfg if cfg is not None else get_config(arch)
    if causal_skip:
        cfg = cfg.scaled(causal_skip=True)
    sh = shape_name if isinstance(shape_name, dict) else SHAPES[shape_name]
    kind = sh["kind"]
    B, S = sh["global_batch"], sh["seq_len"]
    rules = make_rules(cfg, mesh, fsdp=not zero1)
    dp = dp_axes(mesh)
    inputs = _placed_inputs(input_specs(cfg, shape_name, mesh), mesh)
    skeleton = LM(cfg, "meta")

    if kind == "train":
        # each microbatch must divide the DP axes
        nm = TRAIN_MICROBATCHES.get(arch, 1)
        while B // nm % dp_size(mesh) != 0 and nm > 1:
            nm //= 2
        tc = TrainConfig(n_microbatches=nm, opt=AdamWConfig())
        state = shard_train_state(TrainState(
            skeleton, adamw_init(reference_params(skeleton)),
            torch.zeros((), dtype=torch.int32, device="meta")), mesh, rules)
        step = make_train_step(cfg, tc, mesh, rules)
        row = mesh.rows(dp, B // nm)[0]
        placed = (state.tree(), inputs)
        w = walk(step.dry_row, state, inputs)
    else:
        model = ShardedLM.place(skeleton, mesh, rules)
        row = mesh.rows(dp, B)[0]
        dry = {**rules, "_rows": (row,)}
        if kind == "prefill":
            positions = torch.arange(S, dtype=torch.int32, device="meta")
            placed = (model.params, inputs)
            fn = lambda: _logits(model, dry, inputs["inputs"],  # noqa: E731
                                 positions, None)
        else:
            cache = init_cache(cfg, B, S, rules=rules)
            placed = (model.params, cache, inputs)
            fn = lambda: decode_step(model, cache,  # noqa: E731
                                     inputs["tokens"], S - 1, dry)
        with torch.no_grad(), mesh.walk((row.home,)):
            w = walk(fn)
    mem = {"argument": argument_bytes(placed, row.entries), "output": 0,
           "temp": int(w.peak_temp_bytes)}
    name = sh["name"] if isinstance(shape_name, dict) else shape_name
    mf = model_flops_for(cfg, name, active_param_count(cfg), S, B, kind)
    roof = analyze(w, mem, arch=arch, shape=name, mesh_name=mesh_name,
                   chips=chips(mesh), model_flops=mf,
                   row_entries=len(row.entries))
    return mem, roof


def run_cell(arch, shape_name, mesh_name, outdir: Path, verbose=True,
             zero1=False, causal_skip=False):
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    t0 = time.time()
    tag = ("+zero1" if zero1 else "") + ("+cskip" if causal_skip else "")
    mem, roof = lower_cell(arch, shape_name, mesh, mesh_name + tag,
                           zero1=zero1, causal_skip=causal_skip)
    dt = time.time() - t0
    suffix = tag.replace("+", "__")
    out = outdir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    save_json(out, roof)
    if verbose:
        print(f"[OK] {arch} x {shape_name} x {mesh_name} "
              f"({dt:.0f}s walk)")
        print(f"     mem/device: arg={mem['argument']/2**30:.2f}G "
              f"out={mem['output']/2**30:.2f}G "
              f"temp={mem['temp']/2**30:.2f}G")
        print(f"     flops/dev={roof.hlo_flops:.3e} bytes/dev="
              f"{roof.hlo_bytes:.3e} coll={roof.collective_bytes:.3e} "
              f"(one entry of a row of {roof.row_entries} entries)")
        print(f"     terms: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"-> {roof.bottleneck}-bound, useful={roof.useful_ratio:.2f}")
    return roof


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1 instead of FSDP")
    ap.add_argument("--causal-skip", action="store_true",
                    help="triangular attention")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = []
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            ok, why = shape_applicable(a, s)
            if ok:
                cells.append((a, s))
            else:
                print(f"[SKIP] {a} x {s}: {why}")

    failures = []
    for a, s in cells:
        for m in meshes:
            sfx = ("__zero1" if args.zero1 else "") + \
                ("__cskip" if args.causal_skip else "")
            marker = outdir / f"{a}__{s}__{m}{sfx}.json"
            if marker.exists():
                print(f"[CACHED] {a} x {s} x {m}")
                continue
            try:
                run_cell(a, s, m, outdir, zero1=args.zero1,
                         causal_skip=args.causal_skip)
            except Exception as e:
                failures.append((a, s, m, repr(e)))
                print(f"[FAIL] {a} x {s} x {m}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
