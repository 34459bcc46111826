"""Parity at signature widths past 256 bits (f = 288 and 512) on the
paper-structure signature path (``siggen_method="matmul"``, kernel K1,
which the card now runs in slices of 256 columns): port (CPU: K1's plain
twin) against the JAX reference and the table path on the same inputs,
K1's slicing, and the launch counts of the wide kernels. Integer outputs,
exact equality."""
import numpy as np
import pytest
import torch

from repro.core.pipeline import LSHConfig as JCfg, ScalLoPS as JScalLoPS

from repro_torch.core.pipeline import LSHConfig as TCfg, ScalLoPS as TScalLoPS
from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                        make_protein_sets)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.siggen import siggen_slices
from repro_torch.util import u32_to_i32

WIDTHS = [288, 512]


@pytest.mark.parametrize("f", WIDTHS)
def test_matmul_signatures_wide(f):
    """Job 1 through K1's twin (the paper-structure path) against the
    reference's, and against the table path."""
    d = make_protein_sets(SyntheticProteinConfig(
        n_refs=12, n_homolog_queries=0, n_decoy_queries=0, ref_len_mean=50,
        ref_len_std=15, seed=f))
    cfg = dict(k=3, T=13, f=f, scheme="splitmix")
    t = TScalLoPS(TCfg(siggen_method="matmul", **cfg), device="cpu") \
        .signatures(d["ref_ids"], d["ref_lens"])
    j = JScalLoPS(JCfg(siggen_method="matmul", **cfg)).signatures(
        d["ref_ids"], d["ref_lens"])
    assert t.shape == (12, f // 32)
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))
    table = TScalLoPS(TCfg(**cfg), device="cpu").signatures(d["ref_ids"],
                                                             d["ref_lens"])
    np.testing.assert_array_equal(t.numpy(), table.numpy())


@pytest.mark.parametrize("f,slices", [(32, [(0, 32)]), (256, [(0, 256)]),
                                      (288, [(0, 256), (256, 32)]),
                                      (512, [(0, 256), (256, 256)]),
                                      (800, [(0, 256), (256, 256),
                                             (512, 256), (768, 32)])])
def test_siggen_slices(f, slices):
    """K1's grids for f columns: 256-column slices, the last narrower."""
    assert siggen_slices(f) == slices


def test_wide_kernels_count_their_launches(monkeypatch):
    """On CUDA operands each kernel counts one launch a call (K1 too, whose
    call runs a grid per slice), and K2 and K6 take nw = 16 (no 1..8
    refusal before the launch). With no card here the
    device check answers CUDA and the twins stand in for the launchers."""
    from repro_torch.kernels import hamming, siggen
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(siggen, "siggen_accumulate",
                        lambda rows, cb, H, T: ref.siggen_accumulate_ref(
                            rows, cb, H, T))
    monkeypatch.setattr(hamming, "hamming_dist",
                        lambda q, r: ref.hamming_dist_ref(q, r))
    monkeypatch.setattr(hamming, "hamming_count",
                        lambda q, r, *, d: ref.hamming_count_ref(q, r, d))
    rng = np.random.default_rng(3)
    ops.reset_launches()
    rows = torch.from_numpy(rng.integers(-4, 12, (5, 63)).astype(np.int32))
    cb = torch.from_numpy(rng.integers(0, 2, (40, 63)).astype(np.int8))
    H = torch.from_numpy(rng.choice([-1, 1], (40, 512)).astype(np.int8))
    ops.signatures_fused(rows, cb, H, T=13)
    assert ops.LAUNCHES["siggen_accumulate"] == 1
    q = u32_to_i32(rng.integers(0, 2**32, (3, 16), dtype=np.uint64)
                   .astype(np.uint32))
    ops.all_pairs_hamming(q, q)
    ops.hamming_counts(q, q, 1)
    assert ops.LAUNCHES["hamming_dist"] == ops.LAUNCHES["hamming_count"] == 1
    ops.reset_launches()
