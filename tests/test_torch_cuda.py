"""The port's CUDA kernels against their plain torch twins, on the card.

The kernels (K1 siggen, K2 dense Hamming, K3 wavefront SW, K4 ungapped
X-drop, K5 SpGEMM pair emission, K6 Hamming threshold count, K7 row-wave
SW) have no CPU or interpret mode, so every test here is marked ``cuda`` and skips where there is no
card. The file imports no jax, so it also runs on a machine
with the card and without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The twins themselves are held against the JAX reference in
``tests/test_torch_kernels.py``. Outputs are integer: exact equality.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.alphabet import PAD
from repro_torch.core.neighbors import codebook_onehot, shingle_rows
from repro_torch.core.shingle import extract_shingles
from repro_torch.core.simhash import hyperplanes
from repro_torch.kernels import ops, ref
from repro_torch.util import u32_to_i32


def _siggen_inputs(S, k, f, seed):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, 20, (S, k + 4)).astype(np.int8))
    lens = torch.from_numpy(rng.integers(k - 1, k + 5, S).astype(np.int32))
    sh, mask = extract_shingles(ids, lens, k)
    rows = (shingle_rows(sh) * mask[..., None]).reshape(-1, k * 21)[:S]
    scheme = "java" if f <= 32 else "splitmix"
    return (rows.to(torch.int32).contiguous(),
            torch.from_numpy(codebook_onehot(k)),
            torch.from_numpy(hyperplanes(k, f, scheme)))


def _pairs(B, Lq, Lr, seed):
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 20, (B, Lq)).astype(np.int8)
    rs = rng.integers(0, 20, (B, Lr)).astype(np.int8)
    for n in range(B):
        qs[n, rng.integers(0, Lq + 1):] = PAD
        rs[n, rng.integers(Lr // 3, Lr + 1):] = PAD
    qs[-1, :] = PAD
    return qs, rs


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import or collection,
    so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have "
                    "no CPU or interpret mode")
    return torch.device("cuda")


# K1 at k in {2, 3, 4} (D = 42, 63, 84: Dp 64, 64, 96), f from 32 to 256,
# T at 1, the paper's 13, and both sides of the largest k=4 score (44); S
# not a multiple of the 128 or 64 rows a block, and W not a multiple of
# the 128-word tile (400, 8,000, and a cut of k=4's 160,000 words)
@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 13, 44, 45])
@pytest.mark.parametrize("k,f,W", [(2, 32, None), (2, 256, None),
                                   (3, 32, None), (3, 64, None),
                                   (3, 128, None), (4, 96, 159_963),
                                   (4, 256, 159_963)])
def test_siggen_kernel_matches_twin_on_card(cuda_device, k, f, W, T):
    rows, cb, H = _siggen_inputs(1000, k, f, 11 + k)
    t = [a.to(cuda_device) for a in (rows, cb[:W].contiguous(),
                                     H[:W].contiguous())]
    ops.reset_launches()
    ops.RECORDED = {}
    try:
        got = ops.signatures_fused(*t, T=T)
        ops.signatures_fused(*t, T=T + 1)
        recorded = ops.RECORDED
    finally:
        ops.RECORDED = None
    assert ops.LAUNCHES["siggen_accumulate"] == 2
    args, kw = recorded["siggen_accumulate"]        # the first launch only
    assert kw == {"T": T} and all(torch.equal(a, b) for a, b in zip(args, t))
    np.testing.assert_array_equal(
        got.cpu().numpy(), ref.siggen_accumulate_ref(*t, T).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kept_above_127", "row_above_int8",
                                  "dense_codebook", "mixed_blocks",
                                  "d_128", "d_above_128"])
def test_siggen_kernel_is_exact_outside_int8_on_card(cuda_device, case):
    """Inputs off the path. Where kept scores or row values leave int8
    (the first four cases) the blocks whose bound leaves the byte form take
    the exact CUDA-core path, beside blocks on the tensor cores, so K1
    equals its twin with no silent wrap; D = 128 is the widest byte form
    (Dp = 128) and D = 150 runs the exact path throughout."""
    rng = np.random.default_rng(7)
    rows, cb, H = _siggen_inputs(700, 3, 64, 5)
    if case == "kept_above_127":        # scores up to 3 x 90
        rows = rows * 8
    elif case == "row_above_int8":
        rows[::50, 3] = 1000
    elif case == "dense_codebook":      # several nonzero entries a word
        cb = torch.from_numpy(rng.integers(-3, 4, cb.shape).astype(np.int8))
    elif case == "mixed_blocks":        # one block of 128 rows off the byte form
        rows[130:140] = rows[130:140] * 20
    else:                               # D = 128 or 150, 4 ones a word
        D = 128 if case == "d_128" else 150
        rows = torch.from_numpy(rng.integers(-4, 12, (300, D))
                                .astype(np.int32))
        onehot = np.zeros((500, D), np.int8)
        for w in range(500):
            onehot[w, rng.choice(D, 4, replace=False)] = 1
        cb = torch.from_numpy(onehot)
        H = H[:500].contiguous()
    t = [a.to(cuda_device) for a in (rows.contiguous(), cb, H)]
    got = ops.signatures_fused(*t, T=13)
    want = ref.siggen_accumulate_ref(*t, 13)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if case not in ("d_128", "d_above_128"):
        s = ref._exact_mm(t[0], t[1].to(torch.int32).T)
        assert int(torch.where(s >= 13, s, 0).max()) > 127 or \
            int(t[0].abs().max()) > 127


@pytest.mark.cuda
def test_hamming_kernel_matches_twin_on_card(cuda_device):
    rng = np.random.default_rng(12)
    q = u32_to_i32(rng.integers(0, 2**32, (70, 2), dtype=np.uint64)
                   .astype(np.uint32)).to(cuda_device)
    r = u32_to_i32(rng.integers(0, 2**32, (1000, 2), dtype=np.uint64)
                   .astype(np.uint32)).to(cuda_device)
    np.testing.assert_array_equal(ops.all_pairs_hamming(q, r).cpu().numpy(),
                                  ref.hamming_dist_ref(q, r).cpu().numpy())


def _near(rng, Q, R, nw):
    """Refs, and queries 0-3 bits from random refs (random words sit
    ~16*nw bits apart, too far for a small d to count anything)."""
    r = rng.integers(0, 2**32, (R, nw), dtype=np.uint64).astype(np.uint32)
    q = r[rng.integers(0, R, Q)].copy()
    for i in range(Q):
        for b in range(i % 4):
            q[i, b % nw] ^= np.uint32(1) << np.uint32((5 * i + b) % 32)
    return u32_to_i32(q), u32_to_i32(r)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,R,nw,d", [
    (5, 1000, 1, 1),          # Q < 32: the grid splits R to fill the card
    (64, 454_401, 1, 1),      # a serving batch against Swiss-Prot's size
    (300, 777, 2, 2),         # R not a multiple of the 256-row tile
    (1000, 2049, 4, 3),
    (129, 300, 8, 0),
    (40, 3000, 1, 40),        # d past f: every ref counts
])
def test_count_kernel_matches_twin_on_card(cuda_device, Q, R, nw, d):
    q, r = _near(np.random.default_rng(Q + R), Q, R, nw)
    q, r = q.to(cuda_device), r.to(cuda_device)
    ops.reset_launches()
    got = ops.hamming_counts(q, r, d)
    assert ops.LAUNCHES["hamming_count"] == 1
    want = ops.hamming_counts(q.cpu(), r.cpu(), d)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert int(want.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["flip", "band", "dense"])
def test_search_card_equals_cpu(cuda_device, method):
    """ScalLoPS.search with each join on the card and on the CPU (the
    twins): the same pair buffer, count and overflow flag, with masks, at
    a capacity that holds every pair and at one that truncates."""
    from repro_torch.core.pipeline import LSHConfig, ScalLoPS
    q, r = _near(np.random.default_rng(3), 700, 900, 1)
    rng = np.random.default_rng(4)
    qv, rv = rng.random(700) > 0.1, rng.random(900) > 0.1
    cfg = LSHConfig(f=32, d=2, scheme="splitmix", join_method=method)
    ops.reset_launches()
    for mp in (4096, 64):
        a = ScalLoPS(cfg, device=cuda_device).search(
            q, r, max_pairs=mp, q_valid=qv, r_valid=rv)
        b = ScalLoPS(cfg, device="cpu").search(q, r, max_pairs=mp,
                                               q_valid=qv, r_valid=rv)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
        assert bool(b.overflowed) == (mp == 64)
    if method == "dense":
        assert ops.LAUNCHES["hamming_count"] == 2
        assert ops.LAUNCHES["hamming_dist"] >= 2


@pytest.mark.cuda
def test_flip_index_topk_card_equals_cpu(cuda_device):
    from repro_torch.core.pipeline import LSHConfig
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index.service import topk_probe
    from repro_torch.index.store import SignatureIndex
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=500, n_homolog_queries=40, n_decoy_queries=24,
        ref_len_mean=120, ref_len_std=30, seed=5))
    cfg = LSHConfig(f=32, d=2, scheme="splitmix")
    out = []
    for where in (cuda_device, "cpu"):
        idx = SignatureIndex.build(cfg, data["ref_ids"], data["ref_lens"],
                                   layout="flip", device=where)
        qs = idx._pipeline.signatures(data["query_ids"], data["query_lens"])
        out.append([x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                    for x in topk_probe(idx, qs, k=8, cap=4)])
    for x, y in zip(*out):
        np.testing.assert_array_equal(x, y)


def _wave_block(B, Lq, Lr, seed):
    """A pair block for K3/K4: ragged PAD tails, PAD inside the sequences,
    an all-PAD pair inside the block (B > 1), and a first pair that fills
    both widths, a near copy so its best path crosses every strip."""
    qs, rs = _pairs(B, Lq, Lr, seed)
    rng = np.random.default_rng(seed + 1)
    qs[0] = rng.integers(0, 20, Lq)
    rs[0] = rng.integers(0, 20, Lr)
    m = min(Lq, Lr)
    rs[0, :m] = np.where(rng.random(m) < 0.1, rs[0, :m], qs[0, :m])
    if B > 1:
        qs[B // 2 :B // 2 + 1] = PAD
        qs[1:, Lq // 3] = PAD
        rs[1:, Lr // 2] = PAD
    return qs, rs


# (B, Lq, Lr): K3's rows per lane switch at Lq = 128, 256, 512, 768 and
# its 1024-row strips repeat past 1024; B not a multiple of the 4 pairs a
# block; Lr = 1; Lq above and below Lr; the strip buffers in global scratch
# (affine Lr > 2048 or linear Lr > 4096 with more than one strip)
_WAVE_SHAPES = [(9, 40, 250), (9, 300, 250), (9, 1100, 250), (1, 129, 1),
                (6, 257, 1), (5, 513, 700), (7, 769, 300), (6, 1023, 300),
                (5, 1024, 60), (7, 1025, 300), (3, 2049, 2100),
                (2, 8192, 100), (2, 1500, 4500)]


@pytest.mark.cuda
@pytest.mark.parametrize("gap_mode,go,ge", [("linear", None, None),
                                            ("affine", None, None),
                                            ("affine", -4, -4)])
@pytest.mark.parametrize("B,Lq,Lr", _WAVE_SHAPES)
def test_wave_kernel_matches_twin_on_card(cuda_device, gap_mode, go, ge, B,
                                          Lq, Lr):
    qs, rs = _wave_block(B, Lq, Lr, Lq * 3 + Lr)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    kw = dict(gap_mode=gap_mode, gap_open=go, gap_extend=ge)
    got = ops.wavefront_scores(q, r, **kw)
    want = ops.wavefront_scores(q.cpu(), r.cpu(), **kw).numpy()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert want[0] > 0
    if B > 1:
        assert want[B // 2] == 0


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((4, 0), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):          # no signature word
        ops.all_pairs_hamming(q, q)
    with pytest.raises(ValueError):
        ops.hamming_counts(q, q, 1)
    q = torch.zeros((4, 9), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):           # int64 signature words
        ops.hamming_counts(q[:, :2].long(), q[:, :2].long(), 1)
    with pytest.raises(TypeError):           # int64 signature words
        ops.all_pairs_hamming(q.long(), q.long())
    s = torch.zeros((2, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):          # not contiguous
        ops.wavefront_scores(s.t().contiguous().t(), s)
    with pytest.raises(ValueError):          # CPU and CUDA mixed
        ops.wavefront_scores(s, s.cpu())
    from repro_torch.kernels.siggen import siggen_accumulate
    rows = torch.zeros((4, 63), dtype=torch.int32, device=cuda_device)
    cb = torch.zeros((8, 63), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):          # T below 1
        siggen_accumulate(rows, cb, cb[:, :32].contiguous(), 0)
    with pytest.raises(ValueError):          # f not a multiple of 32
        siggen_accumulate(rows, cb, cb[:, :40].contiguous(), 13)


@pytest.mark.cuda
@pytest.mark.parametrize("x", [None, 10, 0])
@pytest.mark.parametrize("B,Lq,Lr", [(9, 40, 250), (9, 300, 250),
                                     (9, 1100, 250), (1, 64, 1), (5, 1, 300),
                                     (7, 600, 40), (3, 300, 1100),
                                     (2, 2000, 1500)])
def test_ungapped_kernel_matches_twin_on_card(cuda_device, x, B, Lq, Lr):
    """Ragged PAD tails, PAD inside, an all-PAD pair inside the block,
    Lr = 1, Lq = 1, B = 1, more diagonals than the block's 1,024 threads;
    finite and no X-drop."""
    qs, rs = _wave_block(B, Lq, Lr, Lq + Lr + 1)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    got = ops.ungapped_wave_scores(q, r, x=x)
    want = ops.ungapped_wave_scores(q.cpu(), r.cpu(), x=x)
    if B > 1:
        assert int(want[B // 2]) == 0
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# K7: (B, Lq, Lr) with B = 9 (the first cases), B = 1, and B = 7, not a
# multiple of the 4 (or 2, or 1) pairs a block; Lr at the columns-per-lane
# steps (32, 384 = 12 a lane) and past one 1,024-column segment up to 8,192;
# Lq of one row, the all-pairs width and past it
_ROWWAVE_SHAPES = [(9, 40, 30), (9, 300, 250), (9, 250, 300),
                   (9, 100, 1100)] + [
    (B, Lq, Lr) for Lq in (1, 384, 2000)
    for Lr in (1, 31, 32, 33, 383, 384, 385, 1023, 1024, 1025, 8192)
    for B in (1, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lr", _ROWWAVE_SHAPES)
def test_rowwave_kernel_matches_twin_and_wavefront_on_card(cuda_device, B,
                                                           Lq, Lr):
    """Ragged PAD tails, PAD inside both sides, an all-PAD pair inside the
    block (B > 1) and a near-copy first pair; K7 == its twin == K3."""
    qs, rs = _wave_block(B, Lq, Lr, Lq * 7 + Lr + B)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    ops.reset_launches()
    got = ops.sw_rowwave_scores(q, r)
    assert ops.LAUNCHES["sw_rowwave"] == 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), ops.sw_rowwave_scores(q.cpu(), r.cpu()).numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(), ops.wavefront_scores(q, r).cpu().numpy())
    if B > 1:
        assert int(got[B // 2]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("Lr", [384, 2100])
def test_rowwave_kernel_first_row_at_lane_boundaries_on_card(cuda_device,
                                                            Lr):
    """A one-residue query (W) against a reference that holds W only at the
    first column of every lane (and of every 1,024-column segment): the
    best is W's self score, taken on row 0 from the boundary's diagonal."""
    from repro_torch.kernels.sw import rowwave_geometry
    cpt = rowwave_geometry(1, Lr).cpt
    r = np.full((3, Lr), 7, np.int8)                # G, which scores -2 vs W
    r[0, ::cpt] = 17                                # W at each lane start
    r[1, 1024::1024] = 17 if Lr > 1024 else 7
    q = np.full((3, 1), 17, np.int8)
    qc, rc = torch.from_numpy(q), torch.from_numpy(r)
    got = ops.sw_rowwave_scores(qc.to(cuda_device), rc.to(cuda_device))
    want = ops.sw_rowwave_scores(qc, rc)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert int(want[0]) == 11


def _slabs(rng, nb, U, E, pad_u=0, pad_e=0, empty_band=False):
    """Band-stacked CSR slabs with random bucket sizes, padded as the
    partition pads them (offsets repeat the end, ids pad with 0)."""
    offs = np.zeros((nb, U + pad_u + 1), np.int32)
    ids = np.zeros((nb, E + pad_e), np.int32)
    for b in range(nb):
        if empty_band and b == 0:
            continue
        cuts = np.sort(rng.integers(0, E, U - 1))
        o = np.concatenate([[0], cuts, [E]])
        offs[b, :U + 1] = o
        offs[b, U + 1:] = E
        ids[b, :E] = rng.permutation(E)
    need = max(int((np.diff(o) * (np.diff(o) - 1) // 2).sum())
               for o in offs)
    return offs, ids, need


@pytest.mark.cuda
@pytest.mark.parametrize("nb,U,E,pad_u,pad_e,empty", [
    (3, 8, 32, 0, 0, False),
    (2, 700, 5000, 324, 3192, False),   # several scan tiles, padded slab
    (2, 40, 300, 0, 0, True),           # an empty band beside a full one
])
def test_upper_pairs_kernel_matches_twin_on_card(cuda_device, nb, U, E,
                                                 pad_u, pad_e, empty):
    rng = np.random.default_rng(U + E)
    offs, ids, need = _slabs(rng, nb, U, E, pad_u, pad_e, empty)
    o, i = torch.from_numpy(offs), torch.from_numpy(ids)
    for cap in (max(need, 1), 2 * max(need, 1) + 5):
        got = ops.emit_upper_pairs(o.to(cuda_device), i.to(cuda_device),
                                   cap=cap)
        want = ops.emit_upper_pairs(o, i, cap=cap)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_allpairs_card_equals_cpu(cuda_device):
    """A small corpus through all_pairs_search on the card (K5, K4, K3)
    and on the CPU (the twins): identical pairs, scores and labels."""
    from repro_torch.allpairs import AllPairsConfig, WaveConfig, \
        all_pairs_search
    from repro_torch.core.pipeline import LSHConfig
    from repro_torch.data.synthetic import FamilyCorpusConfig, \
        make_family_corpus
    c = make_family_corpus(FamilyCorpusConfig(
        n_families=30, family_size=3, n_singletons=60, len_mean=120,
        len_std=30, sub_rate=0.08, seed=4))
    cfg = AllPairsConfig(lsh=LSHConfig(k=3, T=13, f=32, d=1,
                                       scheme="splitmix"),
                         hamming_filter=False,
                         wave=WaveConfig(prefilter=True, prefilter_min=30))
    ops.reset_launches()
    a = all_pairs_search(c["ids"], c["lens"], cfg, device=cuda_device)
    assert ops.LAUNCHES["upper_pairs"] >= 1
    assert ops.LAUNCHES["ungapped_scores"] >= 1
    assert ops.LAUNCHES["wave_scores_linear"] >= 1
    b = all_pairs_search(c["ids"], c["lens"], cfg, device="cpu")
    np.testing.assert_array_equal(a.pairs, b.pairs)
    np.testing.assert_array_equal(a.scored.scores, b.scored.scores)
    np.testing.assert_array_equal(a.scored.kept, b.scored.kept)
    np.testing.assert_array_equal(a.labels, b.labels)


# ----------------------------------------------------------------------
# Widths past 256 bits and lengths past 8,192 residues, and the
# redesigned K2 and K5.

def _twin_dists(q, r, rows=8):
    """K2's twin a few query rows at a time (it forms (rows, R, nw) int64
    temporaries)."""
    return torch.cat([ref.hamming_dist_ref(q[i:i + rows], r)
                      for i in range(0, q.shape[0], rows)])


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 1000, 454_401])
@pytest.mark.parametrize("Q", [1, 64, 70])
@pytest.mark.parametrize("nw", [1, 2, 8, 9, 16, 32])
def test_hamming_dist_kernel_any_width_on_card(cuda_device, nw, Q, R):
    """K2 against its twin (one word a row start: R = 454,401 shifts every
    row's 16-byte groups; R = 1 and 3 are ragged groups only; Q = 70 is
    past one 64-row query tile)."""
    from repro_torch.kernels.hamming import hamming_dist
    rng = np.random.default_rng(nw * 7 + Q + R)
    q = u32_to_i32(rng.integers(0, 2**32, (Q, nw), dtype=np.uint64)
                   .astype(np.uint32)).to(cuda_device)
    r = u32_to_i32(rng.integers(0, 2**32, (R, nw), dtype=np.uint64)
                   .astype(np.uint32)).to(cuda_device)
    want = _twin_dists(q, r)
    got = hamming_dist(q, r)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    ops.reset_launches()
    assert torch.equal(ops.all_pairs_hamming(q, r), want)
    assert ops.LAUNCHES["hamming_dist"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("Q,R,d", [(64, 454_401, 3), (300, 2049, 2),
                                   (5, 1000, 200)])
def test_count_kernel_16_words_on_card(cuda_device, Q, R, d):
    """K6's chunked path (nw = 16) against its twin; d = 200 counts
    nearly every ref."""
    q, r = _near(np.random.default_rng(Q + d), Q, R, 16)
    q, r = q.to(cuda_device), r.to(cuda_device)
    ops.reset_launches()
    got = ops.hamming_counts(q, r, d)
    assert ops.LAUNCHES["hamming_count"] == 1
    want = (_twin_dists(q, r) <= d).sum(1).to(torch.int32)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("f", [288, 512])
@pytest.mark.parametrize("T", [1, 13])
def test_siggen_kernel_wide_on_card(cuda_device, f, T):
    """K1 past 256 columns: one launch, a grid per 256-column slice, each
    writing its columns of V."""
    rows, cb, H = _siggen_inputs(1000, 3, f, 31)
    t = [a.to(cuda_device) for a in (rows, cb, H)]
    ops.reset_launches()
    got = ops.signatures_fused(*t, T=T)
    assert ops.LAUNCHES["siggen_accumulate"] == 1
    assert torch.equal(got, ref.siggen_accumulate_ref(*t, T))


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lr", [(8193, 60), (8193, 2500), (34_350, 40),
                                   (34_350, 20_000), (2100, 20_000)])
@pytest.mark.parametrize("gap_mode", ["linear", "affine"])
def test_wave_kernel_long_queries_on_card(cuda_device, gap_mode, Lq, Lr):
    """K3 past 8,192 query rows (9 and 34 strips), its strip buffers in
    global scratch past Lr = 4,096 (2,048 affine), up to Lr = 20,000."""
    from repro_torch.kernels.sw import wave_geometry
    qs, rs = _wave_block(3, Lq, Lr, Lq + Lr)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    geo = wave_geometry(Lq, Lr, gap_mode == "affine")
    assert geo.strips == -(-Lq // 1024)
    ops.reset_launches()
    got = ops.wavefront_scores(q, r, gap_mode=gap_mode)
    assert ops.LAUNCHES[f"wave_scores_{gap_mode}"] == 1
    want = ref.wave_scores_ref(q, r, gap_open=-11 if gap_mode == "affine"
                               else -4, gap_extend=-1 if gap_mode == "affine"
                               else -4, affine=gap_mode == "affine")
    assert torch.equal(got, want)
    assert int(want[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lr", [(40, 8193), (300, 8193), (40, 34_350),
                                   (3, 34_350), (200, 9000), (3, 60_000)])
def test_rowwave_kernel_long_references_on_card(cuda_device, Lq, Lr):
    """K7 past 8 segments: the warp's profile, H row and masks in per-pair
    global scratch (the scores loaded a segment ahead); == its twin ==
    K3."""
    from repro_torch.kernels.sw import rowwave_geometry
    qs, rs = _wave_block(5, Lq, Lr, Lq * 3 + Lr)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    geo = rowwave_geometry(Lq, Lr)
    assert (geo.scratch_per_pair > 0) == (Lr > 8192)
    ops.reset_launches()
    got = ops.sw_rowwave_scores(q, r)
    assert ops.LAUNCHES["sw_rowwave"] == 1
    assert torch.equal(got, ref.sw_rowwave_ref(q, r))
    assert torch.equal(got, ops.wavefront_scores(q, r))
    assert int(got[0]) > 0


@pytest.mark.cuda
def test_upper_pairs_kernel_big_bucket_on_card(cuda_device):
    """K5 with one bucket of 3,000 entries beside small ones, and a band
    with no pair, caps below and above the total; == the torch index math
    and the twin."""
    from repro_torch.kernels.spgemm import upper_pairs_by_bucket
    rng = np.random.default_rng(9)
    offs = np.array([[0, 40, 3040, 3041, 3100, 3100],
                     [0, 1, 2, 3, 4, 4]], np.int32)
    ids = np.stack([rng.permutation(3100), np.arange(3100)]).astype(np.int32)
    o, i = torch.from_numpy(offs), torch.from_numpy(ids)
    for cap in (1000, 4_500_000, 1 << 23):
        got = ops.emit_upper_pairs(o.to(cuda_device), i.to(cuda_device),
                                   cap=cap).cpu()
        assert torch.equal(got, upper_pairs_by_bucket(o, i, cap=cap))
        assert torch.equal(got, ops.emit_upper_pairs(o, i, cap=cap))


@pytest.mark.cuda
def test_upper_pairs_kernel_myva_shape_on_card(cuda_device):
    """K5 at the myva join's shape: offsets (2, 37,166), ids (2, 192,987),
    cap 4,194,304; buckets of random sizes with a long tail."""
    rng = np.random.default_rng(12)
    U, E = 37_165, 192_987
    offs = np.zeros((2, U + 1), np.int32)
    ids = np.zeros((2, E), np.int32)
    for b in range(2):
        sizes = rng.geometric(0.2, U)
        sizes[rng.integers(0, U, 20)] += rng.integers(100, 600, 20)
        o = np.minimum(np.concatenate([[0], np.cumsum(sizes)]), E)
        offs[b] = o
        ids[b] = rng.permutation(E)
    o, i = torch.from_numpy(offs).to(cuda_device), torch.from_numpy(ids).to(
        cuda_device)
    ops.reset_launches()
    got = ops.emit_upper_pairs(o, i, cap=1 << 22)
    assert ops.LAUNCHES["upper_pairs"] == 1
    want = ref.upper_pairs_ref(o, i, cap=1 << 22)
    assert torch.equal(got, want)
    assert int((want[:, :, 0] >= 0).sum()) > 1 << 20


# ------------------------------------------------------------ quality path
@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4])
def test_neighbor_scores_card_equals_cpu(cuda_device, k):
    from repro_torch.core.neighbors import neighbor_scores, neighbor_weights
    rng = np.random.default_rng(k)
    sh = torch.from_numpy(rng.integers(0, 21, (4, 37, k)).astype(np.int8))
    got = neighbor_scores(sh.to(cuda_device), k)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), neighbor_scores(sh, k))
    assert torch.equal(neighbor_weights(sh.to(cuda_device), k, 13).cpu(),
                       neighbor_weights(sh, k, 13))


@pytest.mark.cuda
@pytest.mark.parametrize("k,T,f,scheme", [(2, 8, 32, "java"),
                                          (3, 13, 32, "java"),
                                          (3, 11, 64, "splitmix")])
def test_device_tables_equal_host_tables(cuda_device, k, T, f, scheme):
    from repro_torch.core.simhash import (contribution_table,
                                          feature_count_table, table_rows)
    np.testing.assert_array_equal(
        table_rows("contrib", k, T, f, scheme, cuda_device).cpu().numpy(),
        contribution_table(k, T, f, scheme))
    np.testing.assert_array_equal(
        table_rows("count", k, T, 0, scheme, cuda_device).cpu().numpy(),
        feature_count_table(k, T))


@pytest.mark.cuda
def test_siggen_kernel_at_quality_config_on_card(cuda_device):
    """K1 at the paper's best-quality point (k=4, D = 84, all 160,000
    words, f = 32, T = 22) against its twin, and the matmul path's
    signatures against the table path's (tables built on the card)."""
    from repro_torch.core.simhash import signatures
    rows, cb, H = _siggen_inputs(3000, 4, 32, 5)
    t = [a.to(cuda_device) for a in (rows, cb, H)]
    ops.reset_launches()
    got = ops.signatures_fused(*t, T=22)
    assert ops.LAUNCHES["siggen_accumulate"] == 1
    assert torch.equal(got, ref.siggen_accumulate_ref(*t, 22, block=1024))
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, 20, (40, 300)).astype(np.int8))
    lens = torch.from_numpy(rng.integers(3, 301, 40).astype(np.int32))
    ids[torch.arange(300)[None, :] >= lens[:, None]] = PAD
    ids, lens = ids.to(cuda_device), lens.to(cuda_device)
    kw = dict(k=4, T=22, f=32, scheme="java")
    assert torch.equal(signatures(ids, lens, method="matmul", **kw),
                       signatures(ids, lens, method="table", **kw))


@pytest.mark.cuda
def test_alignment_api_card_equals_cpu(cuda_device):
    from repro_torch.align import (SeedExtendBaseline,
                                   batch_percent_identity, percent_identity,
                                   sw_align_batch, sw_scores_device,
                                   sw_wave_affine, sw_wave_linear)
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    qs, rs = _pairs(37, 300, 420, 8)
    ops.reset_launches()
    got = sw_align_batch(qs, rs, device=cuda_device)
    assert ops.LAUNCHES["sw_rowwave"] == 1
    np.testing.assert_array_equal(got, sw_align_batch(qs, rs, device="cpu"))
    assert sw_scores_device(qs, rs, device=cuda_device).is_cuda
    for fn in (sw_wave_linear, sw_wave_affine):
        assert torch.equal(fn(qs, rs, device=cuda_device).cpu(),
                           fn(qs, rs, device="cpu"))
    np.testing.assert_array_equal(
        got, sw_wave_linear(qs, rs, device=cuda_device).cpu().numpy())
    assert percent_identity(qs[3], rs[3], device=cuda_device) == \
        percent_identity(qs[3], rs[3], device="cpu")
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=40, n_homolog_queries=8, n_decoy_queries=8,
        ref_len_mean=80, ref_len_std=20, seed=3))
    refs = (data["ref_ids"], data["ref_lens"])
    queries = (data["query_ids"], data["query_lens"])
    pairs = np.stack([np.arange(16) % 16, np.arange(16) * 2,
                      np.zeros(16)], axis=1).astype(np.int32)
    pairs[5] = -1
    a = batch_percent_identity(pairs, *queries, *refs, device=cuda_device)
    b = batch_percent_identity(pairs, *queries, *refs, device="cpu")
    np.testing.assert_array_equal(a, b)
    hits = [SeedExtendBaseline(k=3, T=11, s_min=35, device=d).build_index(
        *refs).search(*queries) for d in (cuda_device, "cpu")]
    assert hits[0] == hits[1] and hits[0]


@pytest.mark.cuda
@pytest.mark.parametrize("container", ["dir", "npz"])
def test_loaded_index_on_card_serves_what_cpu_load_serves(cuda_device,
                                                          tmp_path,
                                                          container):
    from repro_torch.core.pipeline import LSHConfig, ScalLoPS
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index.service import topk_dense, topk_probe
    from repro_torch.index.store import SignatureIndex
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=300, n_homolog_queries=16, n_decoy_queries=16,
        ref_len_mean=120, ref_len_std=30, seed=4))
    cfg = LSHConfig(k=3, T=13, f=64, d=2, scheme="splitmix")
    idx = SignatureIndex.build(cfg, data["ref_ids"][:200],
                               data["ref_lens"][:200], device=cuda_device)
    idx.add(data["ref_ids"][200:], data["ref_lens"][200:])
    path = tmp_path / ("idx" if container == "dir" else "idx.npz")
    idx.save(path)
    q = ScalLoPS(cfg, device="cpu").signatures(data["query_ids"],
                                               data["query_lens"])
    on = [SignatureIndex.load(path, cfg, device=d)
          for d in (cuda_device, "cpu")]
    assert on[0].device.type == "cuda"
    for fn in (lambda i: topk_probe(i, q, k=10, cap=64)[:2],
               lambda i: topk_dense(i, q, k=10)):
        a, b = fn(on[0]), fn(on[1])
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)
