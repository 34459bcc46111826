"""Parity of the port's alignment API, neighbour expansion, seed-and-extend
baseline and k=4 signature paths with the JAX reference on the CPU.

Inputs come from numpy seeds and go to both packages. Scores, lengths,
neighbour scores, hit lists and signatures are integers, compared exactly;
PIDs are floats computed from the same integer counts, compared with
``==`` (NaN rows where the reference has them)."""
import numpy as np
import pytest
import torch

from repro.align import gotoh as j_gotoh
from repro.align import seed_extend as j_se
from repro.align import smith_waterman as j_sw
from repro.core import neighbors as j_nb
from repro.core import simhash as j_sim
from repro.core.alphabet import BLOSUM62_PADDED as J_B62P
from repro.kernels.ref import sw_affine_ref

from repro_torch.align import (SeedExtendBaseline, batch_percent_identity,
                               percent_identity, sw_align_batch, sw_score,
                               sw_scores_device, sw_wave_affine,
                               sw_wave_linear)
from repro_torch.align import seed_extend as t_se
from repro_torch.align.smith_waterman import GAP
from repro_torch.core import neighbors as t_nb
from repro_torch.core import simhash as t_sim
from repro_torch.core.alphabet import BLOSUM62, PAD, encode
from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                        make_protein_sets, mutate,
                                        random_protein)

CPU = "cpu"


def _ragged_block(rng, B, Lq, Lr, *, all_pad_rows=(), len1_rows=()):
    """(B, Lq) x (B, Lr) int8 PAD-padded block with ragged true lengths,
    plus forced all-PAD and length-1 rows (as ``tests/test_gotoh.py``)."""
    qs = np.full((B, Lq), PAD, np.int8)
    rs = np.full((B, Lr), PAD, np.int8)
    for b in range(B):
        if b in all_pad_rows:
            continue
        lq = 1 if b in len1_rows else int(rng.integers(1, Lq + 1))
        lr = 1 if b in len1_rows else int(rng.integers(1, Lr + 1))
        qs[b, :lq] = rng.integers(0, 20, lq, dtype=np.int8)
        rs[b, :lr] = rng.integers(0, 20, lr, dtype=np.int8)
    return qs, rs


@pytest.fixture(scope="module")
def block():
    return _ragged_block(np.random.default_rng(7), 24, 96, 80,
                         all_pad_rows=(0, 17), len1_rows=(1, 9))


# ------------------------------------------------------------ smith-waterman
def test_pid_of_identical_and_known_alignments():
    q = encode("MDESFGLLLESMQ")
    got = percent_identity(q, q, device=CPU)
    assert got == j_sw.percent_identity(q, q)
    assert got[0] == 100.0 and got[1] == len(q)
    assert got[2] == sum(int(BLOSUM62[a, a]) for a in q)
    q, r = encode("AAAWDERKQYTAAA"), encode("PPPWDERKQYTPPP")
    got = percent_identity(q, r, device=CPU)
    assert got == j_sw.percent_identity(q, r)
    assert got[:2] == (100.0, 8)                          # WDERKQYT


def test_pid_of_mutated_pairs_matches_reference():
    rng = np.random.default_rng(0)
    for rate in (0.05, 0.2, 0.4):
        base = random_protein(rng, 120)
        m = mutate(rng, base, sub_rate=rate)
        got = percent_identity(base, m, device=CPU)
        assert got == j_sw.percent_identity(base, m)
        assert isinstance(got[0], float) and isinstance(got[1], int)


def test_sw_batch_single_and_device_scores_match_reference(block):
    qs, rs = block
    want = j_sw.sw_align_batch(qs, rs)
    got = sw_align_batch(qs, rs, device=CPU)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    dev = sw_scores_device(qs, rs, device=CPU)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), want)
    for i in (2, 5, 9):
        assert sw_score(qs[i], rs[i], device=CPU) == \
            j_sw.sw_score(qs[i], rs[i]) == want[i]


def test_batch_percent_identity_matches_reference_with_nan_rows():
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=12, n_homolog_queries=6, n_decoy_queries=2,
        ref_len_mean=50, ref_len_std=15, seed=4))
    rng = np.random.default_rng(5)
    pairs = np.stack([rng.integers(0, 8, 40), rng.integers(0, 12, 40),
                      rng.integers(0, 5, 40)], axis=1).astype(np.int32)
    pairs[[0, 7, 31, 39]] = -1                   # invalid rows -> nan
    args = (data["query_ids"], data["query_lens"], data["ref_ids"],
            data["ref_lens"])
    want = j_sw.batch_percent_identity(pairs, *args)
    got = batch_percent_identity(torch.from_numpy(pairs), *args, device=CPU)
    assert np.isnan(got[[0, 7, 31, 39]]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert (got[ok] == want[ok]).all()
    assert np.isnan(batch_percent_identity(pairs[[0]], *args,
                                           device=CPU)).all()


# ------------------------------------------------------------ wavefront API
def test_wave_linear_matches_reference_and_row_wave(block):
    qs, rs = block
    got = sw_wave_linear(qs, rs, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_gotoh.sw_wave_linear(qs, rs)))
    np.testing.assert_array_equal(got.numpy(),
                                  sw_align_batch(qs, rs, device=CPU))
    for gap in (-11, -1):
        np.testing.assert_array_equal(
            sw_wave_linear(qs, rs, gap=gap, device=CPU).numpy(),
            np.asarray(j_gotoh.sw_wave_linear(qs, rs, gap=gap)))


@pytest.mark.parametrize("shape", ["empty_and_singleton", "odd_diagonals"])
def test_wave_linear_and_affine_edge_blocks(shape):
    if shape == "empty_and_singleton":
        qs = np.full((2, 4), PAD, np.int8)
        rs = np.full((2, 4), PAD, np.int8)
        qs[1, 0] = rs[1, 0] = 5
    else:        # Lq + Lr - 1 not a multiple of the reference's chunk
        qs, rs = _ragged_block(np.random.default_rng(11), 8, 7, 6)
    lin = sw_wave_linear(qs, rs, device=CPU).numpy()
    np.testing.assert_array_equal(lin,
                                  np.asarray(j_gotoh.sw_wave_linear(qs, rs)))
    np.testing.assert_array_equal(lin, j_sw.sw_align_batch(qs, rs))
    np.testing.assert_array_equal(
        sw_wave_affine(qs, rs, device=CPU).numpy(),
        np.asarray(j_gotoh.sw_wave_affine(qs, rs)))
    if shape == "empty_and_singleton":
        assert lin[0] == 0


def test_wave_affine_matches_reference_and_oracle(block):
    qs, rs = block
    got = sw_wave_affine(qs, rs, device=CPU).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(j_gotoh.sw_wave_affine(qs, rs)))
    for b in range(qs.shape[0]):
        want, _ = sw_affine_ref(qs[b][qs[b] != PAD], rs[b][rs[b] != PAD])
        assert got[b] == want, f"row {b}"
    # open == extend is the linear recurrence
    np.testing.assert_array_equal(
        sw_wave_affine(qs, rs, gap_open=GAP, gap_extend=GAP,
                       device=CPU).numpy(),
        j_sw.sw_align_batch(qs, rs))


# ------------------------------------------------------------ neighbours
@pytest.mark.parametrize("k", [2, 3, 4])
def test_neighbor_scores_and_weights_match_reference(k):
    rng = np.random.default_rng(k)
    sh = rng.integers(0, 21, (3, 5, k)).astype(np.int8)    # PAD included
    want = np.asarray(j_nb.neighbor_scores(sh, k))
    got = t_nb.neighbor_scores(torch.from_numpy(sh), k)
    assert got.dtype == torch.int32 and got.shape == (3, 5, 20**k)
    np.testing.assert_array_equal(got.numpy(), want)
    T = {2: 8, 3: 13, 4: 22}[k]
    np.testing.assert_array_equal(
        t_nb.neighbor_weights(torch.from_numpy(sh), k, T).numpy(),
        np.asarray(j_nb.neighbor_weights(sh, k, T)))


def test_neighbor_scores_ignore_the_callers_matmul_precision():
    sh = torch.from_numpy(
        np.random.default_rng(1).integers(0, 20, (7, 3)).astype(np.int8))
    want = t_nb.neighbor_scores(sh, 3)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = t_nb.neighbor_scores(sh, 3)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


# ------------------------------------------------------------ seed-extend
def test_kadane_diagonals_equal_the_scalar_loop():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 90)
    refs = rng.integers(0, 20, (6, 70))
    n = 300
    r = rng.integers(0, 6, n)
    dg = rng.integers(-89, 70, n)
    i0 = np.maximum(0, -dg)
    j0 = i0 + dg
    L = np.minimum(len(q) - i0, refs.shape[1] - j0)
    ok = L >= 1
    r, i0, j0, L = r[ok], i0[ok], j0[ok], L[ok]
    got = t_se._kadane_diagonals(q, refs, r, i0, j0, L)
    want = [j_se._kadane(J_B62P[q[a:a + m], refs[x, b:b + m]])
            for x, a, b, m in zip(r, i0, j0, L)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,T,s_min", [(3, 11, 30), (2, 8, 25)])
def test_seed_extend_hits_equal_reference_in_order(k, T, s_min):
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=24, n_homolog_queries=8, n_decoy_queries=8,
        ref_len_mean=80, ref_len_std=10, sub_rates=(0.05, 0.25), seed=2))
    refs = (data["ref_ids"], data["ref_lens"])
    qs = (data["query_ids"], data["query_lens"])
    want = j_se.SeedExtendBaseline(k=k, T=T, s_min=s_min).build_index(
        *refs).search(*qs)
    got = SeedExtendBaseline(k=k, T=T, s_min=s_min,
                             device=CPU).build_index(*refs).search(*qs)
    assert got == want                        # the list, order included
    assert all(type(x) is int for hit in got for x in hit)
    # every homolog query hits its parent (``tests/test_align_data.py``)
    found = {(q, r) for q, r, _ in got}
    for qi, (parent, _) in enumerate(data["truth"]):
        if parent >= 0 and k == 3:
            assert (qi, parent) in found


# ------------------------------------------------------------ k=4 job 1
def test_matmul_signatures_at_k4_match_reference():
    """The paper's best-quality point (k=4, T=22, java) through the matmul
    path on 3 short sequences (~230 shingles)."""
    rng = np.random.default_rng(9)
    lens = np.array([90, 75, 77], np.int32)
    ids = np.full((3, 90), PAD, np.int8)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(0, 20, n)
    want = np.asarray(j_sim.signatures_matmul(ids, lens, k=4, T=22, f=32,
                                              scheme="java"))
    got = t_sim.signatures_matmul(torch.from_numpy(ids),
                                  torch.from_numpy(lens), k=4, T=22, f=32,
                                  scheme="java")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("kind", ["contrib", "count"])
def test_k4_table_blocks_match_reference_formula(kind, monkeypatch):
    """Rows of the k=4 tables as the card builds them (``table_rows``, run
    here on the CPU) against the reference's block formula on the same
    rows (``repro/core/simhash.py``): three ranges of at most 640 words,
    start, middle and end of the codebook. The block is cut to 256 words
    so each range runs the block loop more than once, with a
    short last block, at a tenth of a full block's memory."""
    monkeypatch.setattr(t_sim, "TABLE_BLOCK", 256)
    k, T, f = 4, 22, 32
    cb = j_nb.codebook(k).astype(np.int64)
    cb_f = j_nb.codebook_onehot(k).T.astype(np.float32)
    H_f = j_sim.hyperplanes(k, f, "java").astype(np.float32)
    for lo, hi in ((0, 640), (69_312, 69_952), (159_488, 160_000)):
        rows = J_B62P[cb[lo:hi]].reshape(hi - lo, -1).astype(np.float32)
        scores = rows @ cb_f
        if kind == "contrib":
            want = (np.where(scores >= T, scores, 0.0) @ H_f).astype(np.int32)
        else:
            want = (scores >= T).sum(axis=1).astype(np.int32)
        got = t_sim.table_rows(kind, k, T, f, "java", torch.device(CPU),
                               lo, hi)
        np.testing.assert_array_equal(got.numpy(), want)
