"""Set-up shared by the drivers: the reference database made from the
seed, the LSH configuration and the signature index of a deployment, and
the check of the index's signatures against the reference."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bench import gen
from bench.reference.simhash import Job1

REFS_STREAM = 0             # generator stream of the reference database


@dataclass
class Queries:
    """One query set on the host, as a client holds it."""
    ids: np.ndarray           # (n, W) int8, PAD-padded
    lens: np.ndarray          # (n,) int32


def lsh_config(config: dict, d: int | None = None):
    from repro_torch.core.pipeline import LSHConfig
    kw = dict(config["lsh"])
    if d is not None:
        kw["d"] = int(d)
    return LSHConfig(**kw)


def make_refs(config: dict, seed: int, device):
    """The reference database on ``device``: (ids, lens int64)."""
    return gen.proteins(config["refs"], seed, REFS_STREAM, device)


def build_index(config: dict, lsh, ref_ids, ref_lens, device):
    from repro_torch.index.store import SignatureIndex
    return SignatureIndex.build(lsh, ref_ids, ref_lens, device=device,
                                **config["index"])


def reference_job1(lsh, device) -> Job1:
    return Job1(lsh.k, lsh.T, lsh.f, device)


def ref_rows_wrong(ref_sigs: np.ndarray, ref_valid: np.ndarray,
                   index_sigs: np.ndarray, index_valid: np.ndarray) -> int:
    """References whose signature or validity in the index differs from
    the reference's."""
    if index_sigs.shape != ref_sigs.shape:
        return int(ref_sigs.shape[0])
    bad = (index_sigs != ref_sigs).any(axis=1) | (index_valid != ref_valid)
    return int(bad.sum())


def release(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
