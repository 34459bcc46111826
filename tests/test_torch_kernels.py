"""The port's kernels (K1 siggen, K2 dense Hamming, K3 wavefront SW, K4
ungapped X-drop, K6 Hamming threshold count, K7 row-wave SW) against the
JAX reference (K5's twin is held against its Pallas kernel in
``tests/test_torch_spgemm.py``).

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its kernel's
plain twin; those twins are held here against the JAX Pallas kernels (in
interpret mode, as ``tests/test_kernels.py`` runs them) and the host
oracles. The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py``). Every output is integer, so the tolerance
is exact equality.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

from repro_torch.core.alphabet import PAD
from repro_torch.core.neighbors import codebook_onehot, shingle_rows
from repro_torch.core.shingle import extract_shingles
from repro_torch.core.simhash import hyperplanes
from repro_torch.kernels import ops, ref
from repro_torch.util import u32_to_i32


def _siggen_inputs(S, k, f, seed):
    """Genuine shingle rows (masked rows zero), the one-hot codebook and
    the hyperplanes, as numpy. Built by the port's job-1 modules, which
    ``test_torch_core.py`` holds equal to the reference's."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 20, (S, k + 4)).astype(np.int8)
    lens = rng.integers(k - 1, k + 5, S).astype(np.int32)   # some invalid
    sh, mask = extract_shingles(torch.from_numpy(ids), torch.from_numpy(lens),
                                k)
    rows = (shingle_rows(sh) * mask[..., None]).reshape(-1, k * 21)[:S]
    rows = rows.numpy().astype(np.int32)
    scheme = "java" if f <= 32 else "splitmix"
    return rows, codebook_onehot(k), hyperplanes(k, f, scheme)


def _pairs(B, Lq, Lr, seed):
    """Random residues with ragged PAD tails (some rows all PAD)."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 20, (B, Lq)).astype(np.int8)
    rs = rng.integers(0, 20, (B, Lr)).astype(np.int8)
    for n in range(B):
        qs[n, rng.integers(0, Lq + 1):] = PAD
        rs[n, rng.integers(Lr // 3, Lr + 1):] = PAD
    qs[-1, :] = PAD
    return qs, rs


# ------------------------------------------------------------ K1 siggen
@pytest.mark.parametrize("S,k,f,T,bs,bw", [
    (16, 2, 32, 8, 8, 128),
    (50, 2, 64, 10, 16, 200),     # ragged blocks on the reference side
    (64, 3, 32, 13, 64, 512),     # the paper's k=3/T=13
])
def test_siggen_twin_matches_pallas_kernel(S, k, f, T, bs, bw):
    rows, cb, H = _siggen_inputs(S, k, f, S + k)
    want = np.asarray(j_ops.signatures_fused(
        jnp.asarray(rows), jnp.asarray(cb), jnp.asarray(H), T=T, bs=bs,
        bw=bw))
    np.testing.assert_array_equal(
        np.asarray(j_ref.siggen_accumulate_ref(rows, cb, H, T)), want)
    got = ops.signatures_fused(torch.from_numpy(rows), torch.from_numpy(cb),
                               torch.from_numpy(H), T=T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_siggen_twin_blocking_is_exact():
    rows, cb, H = _siggen_inputs(40, 3, 64, 1)
    t = [torch.from_numpy(a) for a in (rows, cb, H)]
    np.testing.assert_array_equal(
        ref.siggen_accumulate_ref(*t, 13, block=7).numpy(),
        ref.siggen_accumulate_ref(*t, 13).numpy())


def test_siggen_rejects_threshold_below_one():
    rows, cb, H = _siggen_inputs(8, 2, 32, 0)
    with pytest.raises(ValueError):
        ops.signatures_fused(torch.from_numpy(rows), torch.from_numpy(cb),
                             torch.from_numpy(H), T=0)


@pytest.mark.parametrize("D", [0, 21, 42, 63, 64, 65, 84, 96, 97, 128,
                               129, 300])
def test_siggen_geometry(D):
    """K1's launch geometry: D zero-padded to a multiple of 32 (at least
    64) up to 128, else the exact path (dp 0, f ints a warp of shared
    memory); 128 rows a block for f <= 64, else 64; W padded to the 128-word
    tile; shared memory within the card's 227 KB a block."""
    from repro_torch.kernels.siggen import (SIGGEN_BW, SIGGEN_DP_MAX,
                                            siggen_geometry)
    for f in range(32, 257, 32):
        for W in (1, 400, 8000, 8001, 160_000):
            g = siggen_geometry(D, W, f)
            assert g.rows_per_block == (128 if f <= 64 else 64)
            if D > SIGGEN_DP_MAX:
                assert (g.dp, g.words, g.smem_bytes) == (0, W, 4 * f * 4)
                continue
            assert g.dp % 32 == 0 and g.dp >= max(D, 64)
            assert g.dp - 32 < max(D, 33)
            assert g.words % SIGGEN_BW == 0 and 0 <= g.words - W < SIGGEN_BW
            assert g.smem_bytes == ((g.rows_per_block + 2 * SIGGEN_BW)
                                    * (g.dp + 16) + 2 * f * (SIGGEN_BW + 16))
            assert g.smem_bytes <= 232_448


def test_siggen_slot_word_is_the_fragment_hand_off():
    """Thread (g, t) holds accumulator words 8j + 2t + e (e = 0, 1) of each
    n8 tile j; packed in the kernel's order they are A-fragment slots
    4t..4t+3 (tiles 0, 1) and 16 + 4t.. (tiles 2, 3): slot_word maps each
    slot to the word that sits there, one to one within each 32-word
    chunk, the same on numpy arrays and torch tensors."""
    from repro_torch.kernels.siggen import slot_word
    perm = slot_word(np.arange(96))
    assert np.array_equal(slot_word(torch.arange(96)).numpy(), perm)
    for c in range(3):
        assert sorted(perm[32 * c:32 * c + 32] - 32 * c) == list(range(32))
    for t in range(4):
        held = [8 * j + 2 * t + e for j in (0, 1) for e in (0, 1)]
        assert perm[4 * t:4 * t + 4].tolist() == held
        assert perm[16 + 4 * t:20 + 4 * t].tolist() == [w + 16 for w in held]


def _k1_emulate(rows, cb, H, T):
    """numpy emulation of ``csrc/siggen.cu``'s byte form, fragment by
    fragment: product 1's m16n8 accumulators (started at -T) of a 32-word
    chunk, narrowed to bytes, thresholded with the sign-byte mask, placed
    as product 2's m16n8k32 A fragment and multiplied with the wrapper's
    transposed, slot_word-ordered H (the inputs here never leave the byte
    form)."""
    from repro_torch.kernels.siggen import siggen_geometry, siggen_operands
    S, D = rows.shape
    W, f = H.shape
    geo = siggen_geometry(D, W, f)
    cbp, htp, cb_l1 = (t.numpy().astype(np.int64) for t in siggen_operands(
        torch.from_numpy(cb), torch.from_numpy(H), geo))
    bs = geo.rows_per_block
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    V = np.zeros((-(-S // bs) * bs, f), np.int64)
    for row0 in range(0, S, bs):
        x = np.zeros((bs, geo.dp), np.int64)
        blk = rows[row0:row0 + bs]
        x[:len(blk), :D] = blk
        bound = int(np.abs(x).max()) * int(cb_l1[0])
        assert np.abs(x).max() <= 127 and bound + T <= 128
        for m0 in range(0, bs, 16):
            for c0 in range(0, geo.words, 32):
                sc = x[m0:m0 + 16] @ cbp[c0:c0 + 32].T - T      # (16, 32)
                A2 = np.zeros((16, 32), np.int64)
                for reg in range(4):      # a0..a3: rows g, g+8; slots +0, +16
                    rows_ = g + 8 * (reg & 1)
                    tiles = (0, 1) if reg < 2 else (2, 3)
                    held = [sc[rows_, 8 * j + 2 * t + e]
                            for j in tiles for e in (0, 1)]
                    for byte, val in enumerate(held):
                        P = val & 0xFF
                        keep = np.where(P >= 128, 0, 0xFF)
                        kept = (P & keep) + (T & keep)
                        assert (kept < 128).all()
                        A2[rows_, 16 * (reg >> 1) + 4 * t + byte] = kept
                V[row0 + m0:row0 + m0 + 16] += A2 @ htp[:, c0:c0 + 32].T
    return V[:S].astype(np.int32)


@pytest.mark.parametrize("S,k,f,T", [(150, 2, 32, 8), (70, 3, 64, 13),
                                     (20, 2, 96, 1), (40, 2, 32, 23)])
def test_siggen_fragment_emulation_matches_twin(S, k, f, T):
    rows, cb, H = _siggen_inputs(S, k, f, S + k)
    want = ref.siggen_accumulate_ref(*(torch.from_numpy(a)
                                       for a in (rows, cb, H)), T).numpy()
    np.testing.assert_array_equal(_k1_emulate(rows, cb, H, T), want)


# ------------------------------------------------------------ K2 hamming
@pytest.mark.parametrize("Q,R,nw", [(8, 8, 1), (37, 61, 2), (5, 300, 4)])
def test_hamming_twin_matches_pallas_kernel(Q, R, nw):
    rng = np.random.default_rng(Q * 1000 + R)
    q = rng.integers(0, 2**32, (Q, nw), dtype=np.uint64).astype(np.uint32)
    r = rng.integers(0, 2**32, (R, nw), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(j_ops.all_pairs_hamming(jnp.asarray(q), jnp.asarray(r),
                                              bq=8, br=128))
    got = ops.all_pairs_hamming(u32_to_i32(q), u32_to_i32(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ K6 count
@settings(max_examples=10, deadline=None)
@given(
    Q=st.integers(1, 40), R=st.integers(1, 70),
    nw=st.sampled_from([1, 2, 4]), d=st.integers(0, 64),
    seed=st.integers(0, 2**16),
)
def test_hamming_count_twin_matches_pallas_kernel(Q, R, nw, d, seed):
    """The reference's property test (``tests/test_properties.py``): the
    Pallas kernel pads refs with all-ones rows and subtracts their hits;
    the twin (and K6) has no padding to undo."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2**32, (Q, nw), dtype=np.uint32)
    r = rng.integers(0, 2**32, (R, nw), dtype=np.uint32)
    want = np.asarray(j_ops.hamming_counts(jnp.asarray(q), jnp.asarray(r), d,
                                           bq=8, br=16))
    got = ops.hamming_counts(u32_to_i32(q), u32_to_i32(r), d)
    assert got.dtype == torch.int32 and got.shape == (Q,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [0, 2])
def test_hamming_count_twin_near_neighbours(d):
    """Queries planted 0-3 bits from refs (random words sit ~nw*16 bits
    apart, so random inputs test the all-or-nothing ends of d), a ragged
    ref tile, and an all-ones query (the reference's pad pattern)."""
    rng = np.random.default_rng(d)
    r = rng.integers(0, 2**32, (37, 2), dtype=np.uint32)
    q = r[rng.integers(0, 37, 13)].copy()
    for i in range(13):
        for b in range(i % 4):
            q[i, b % 2] ^= np.uint32(1) << np.uint32((5 * i + b) % 32)
    q[-1] = 0xFFFFFFFF
    r[-1] = 0xFFFFFFFE
    want = np.asarray(j_ops.hamming_counts(jnp.asarray(q), jnp.asarray(r), d,
                                           bq=8, br=16))
    got = ops.hamming_counts(u32_to_i32(q), u32_to_i32(r), d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), (ref.hamming_dist_ref(u32_to_i32(q), u32_to_i32(r))
                      <= d).sum(1).numpy())
    assert want.max() > 0


# ------------------------------------------------------------ K3 wavefront
@pytest.mark.parametrize("gap_mode", ["linear", "affine"])
@pytest.mark.parametrize("B,Lq,Lr", [(5, 17, 23), (4, 24, 9)])
def test_wave_twin_matches_pallas_kernel(gap_mode, B, Lq, Lr):
    qs, rs = _pairs(B, Lq, Lr, B * 100 + Lq)
    want = np.asarray(j_ops.wavefront_scores(qs, rs, gap_mode=gap_mode,
                                             bb=4))
    got = ops.wavefront_scores(torch.from_numpy(qs), torch.from_numpy(rs),
                               gap_mode=gap_mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("go,ge", [(-11, -1), (-4, -4), (-6, -2)])
def test_wave_twin_matches_host_gotoh_oracle(go, ge):
    """Unpadded pairs scored by the -inf-boundary host oracle; the twin
    sees them inside a PAD-padded block. open == extend is linear."""
    rng = np.random.default_rng(-go * 10 - ge)
    B, Lq, Lr = 6, 40, 33
    qs = np.full((B, Lq), PAD, np.int8)
    rs = np.full((B, Lr), PAD, np.int8)
    pairs = []
    for n in range(B):
        lq, lr = rng.integers(1, Lq + 1), rng.integers(1, Lr + 1)
        q = rng.integers(0, 20, lq).astype(np.int8)
        r = rng.integers(0, 20, lr).astype(np.int8)
        if n == 0:      # a planted near-copy so the score is large
            lr = lq = min(lq, Lr)
            q = q[:lq]
            r = q.copy()
            r[::5] = (r[::5] + 1) % 20
        qs[n, :lq], rs[n, :lr] = q, r
        pairs.append((q, r))
    want = [ref.sw_affine_ref(q, r, go, ge)[0] for q, r in pairs]
    for q, r in pairs[:2]:      # the port's oracle is the reference's
        assert ref.sw_affine_ref(q, r, go, ge)[0] == \
            j_ref.sw_affine_ref(q, r, go, ge)[0]
    gap_mode = "linear" if go == ge else "affine"
    got = ops.wavefront_scores(torch.from_numpy(qs), torch.from_numpy(rs),
                               gap_mode=gap_mode, gap_open=go,
                               gap_extend=ge)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wave_twin_int16_and_int32_lanes_agree():
    from repro_torch.align import gotoh
    qs, rs = _pairs(3, 30, 30, 9)
    assert gotoh.lane_dtype(30, 30) == torch.int16
    assert gotoh.lane_dtype(2000, 10) == torch.int32
    q, r = torch.from_numpy(qs), torch.from_numpy(rs)
    kw = dict(gap_open=-11, gap_extend=-1, affine=True)
    a = gotoh.wave_scores(q, r, **kw)
    orig = gotoh.lane_dtype
    try:
        gotoh.lane_dtype = lambda Lq, Lr: torch.int32
        b = gotoh.wave_scores(q, r, **kw)
    finally:
        gotoh.lane_dtype = orig
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_rowwave_matches_reference_rowwave():
    from repro.align.smith_waterman import _sw_scores_batch
    from repro_torch.align.smith_waterman import dp_scores_block
    qs, rs = _pairs(5, 19, 26, 3)
    want = np.asarray(_sw_scores_batch(jnp.asarray(qs), jnp.asarray(rs)))
    got = dp_scores_block(torch.from_numpy(qs), torch.from_numpy(rs),
                          dp_kernel="rowwave")
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ K7 row wave
@pytest.mark.parametrize("B,Lq,Lr", [(5, 17, 23), (4, 24, 9)])
def test_rowwave_twin_matches_pallas_kernel(B, Lq, Lr):
    qs, rs = _pairs(B, Lq, Lr, B * 10 + Lr)
    want = np.asarray(j_ops.sw_wave_scores(qs, rs, bb=4, interpret=True))
    got = ops.sw_rowwave_scores(torch.from_numpy(qs), torch.from_numpy(rs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ K4 ungapped
@pytest.mark.parametrize("x", [None, 10, 0])
@pytest.mark.parametrize("B,Lq,Lr", [(5, 17, 23), (4, 24, 9)])
def test_ungapped_twin_matches_pallas_kernel(x, B, Lq, Lr):
    """The Pallas kernel takes x=2^30 for no drop (``tiles.py``); the
    reference's jnp scan takes None. The twin matches both."""
    from repro.align.smith_waterman import ungapped_xdrop_scores
    qs, rs = _pairs(B, Lq, Lr, B * 100 + Lr)
    want = np.asarray(j_ops.ungapped_wave_scores(
        qs, rs, x=2**30 if x is None else x, bb=4, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(ungapped_xdrop_scores(qs, rs, x=x)), want)
    got = ops.ungapped_wave_scores(torch.from_numpy(qs),
                                   torch.from_numpy(rs), x=x)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[-1] == 0                        # the all-PAD row


def test_ungapped_twin_matches_host_oracle():
    """Unpadded pairs walked cell by cell by the reference's host oracle;
    the twin sees them inside a PAD-padded block."""
    rng = np.random.default_rng(5)
    B, L = 6, 40
    qs = np.full((B, L), PAD, np.int8)
    rs = np.full((B, L), PAD, np.int8)
    pairs = []
    for n in range(B):
        lq, lr = rng.integers(1, L + 1, 2)
        q = rng.integers(0, 20, lq).astype(np.int8)
        r = q[:lr].copy() if n % 2 else rng.integers(0, 20, lr).astype(
            np.int8)
        qs[n, :len(q)], rs[n, :len(r)] = q, r
        pairs.append((q, r))
    for x in (3, 2**30):
        want = [j_ref.ungapped_xdrop_ref(q, r, x) for q, r in pairs]
        got = ops.ungapped_wave_scores(torch.from_numpy(qs),
                                       torch.from_numpy(rs), x=x)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------- K3 / K4 redesign identities
_TRIM_CASES = ["tails", "all_pad", "length1", "inner_pad"]


def _trim_block(case, seed):
    """A (6, 40) x (6, 33) block of one kind: random PAD tails, all-PAD
    rows on either side, length-1 pairs, or PAD inside the sequences."""
    rng = np.random.default_rng(seed)
    B, Lq, Lr = 6, 40, 33
    qs = rng.integers(0, 20, (B, Lq)).astype(np.int8)
    rs = rng.integers(0, 20, (B, Lr)).astype(np.int8)
    rs[0, :20] = qs[0, :20]          # a high-scoring pair
    for n in range(B):
        qs[n, rng.integers(1, Lq + 1):] = PAD
        rs[n, rng.integers(1, Lr + 1):] = PAD
    if case == "all_pad":
        qs[1, :] = PAD
        rs[2, :] = PAD
        qs[3, :] = rs[3, :] = PAD
    elif case == "length1":
        qs[1, 1:] = PAD
        rs[2, 1:] = PAD
        qs[3, 1:] = rs[3, 1:] = PAD
        qs[4, 0] = rs[4, 0] = 7      # one matching cell
        qs[4, 1:] = rs[4, 1:] = PAD
    elif case == "inner_pad":
        qs[:, 3] = PAD
        rs[:, 5] = PAD
        qs[0, 10:12] = PAD
    return qs, rs


def _last_residue_extent(x):
    real = np.flatnonzero(x != PAD)
    return int(real[-1]) + 1 if len(real) else 0


@pytest.mark.parametrize("gap_mode,go,ge", [("linear", -4, -4),
                                            ("affine", -11, -1),
                                            ("affine", -4, -4)])
@pytest.mark.parametrize("case", _TRIM_CASES)
def test_wave_scores_equal_on_pairs_cut_at_last_residues(case, gap_mode, go,
                                                         ge):
    """K3 trims each pair to its last non-PAD residue on each side and
    scores a pair with no residue on a side 0: the twin on the padded
    block equals the twin on each cut pair, and the reference's sweep."""
    from repro.align.gotoh import sw_wave_affine, sw_wave_linear
    from repro_torch.align.gotoh import wave_scores
    qs, rs = _trim_block(case, len(case) * 10 + go)
    kw = dict(gap_open=go, gap_extend=ge, affine=gap_mode == "affine")
    got = wave_scores(torch.from_numpy(qs), torch.from_numpy(rs), **kw)
    cut = []
    for q, r in zip(qs, rs):
        lq, lr = _last_residue_extent(q), _last_residue_extent(r)
        cut.append(0 if lq == 0 or lr == 0 else int(wave_scores(
            torch.from_numpy(q[None, :lq].copy()),
            torch.from_numpy(r[None, :lr].copy()), **kw)[0]))
    if gap_mode == "linear":
        want = np.asarray(sw_wave_linear(qs, rs, gap=go))
    else:
        want = np.asarray(sw_wave_affine(qs, rs, gap_open=go, gap_extend=ge))
    np.testing.assert_array_equal(got.numpy(), cut)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() > 0


def _ungapped_no_drop_walk(qs, rs):
    """Per pair, per diagonal: cur = max(cur + s, 0) with PAD cells at
    -10^6, the best cur over all cells."""
    from repro_torch.core.alphabet import BLOSUM62_PADDED
    out = []
    for q, r in zip(qs.astype(np.int64), rs.astype(np.int64)):
        s = np.where((q[:, None] != PAD) & (r[None, :] != PAD),
                     BLOSUM62_PADDED[q][:, r], -10**6)
        best = 0
        for k in range(-(len(q) - 1), len(r)):
            cur = 0
            for v in np.diagonal(s, k):
                cur = max(cur + int(v), 0)
                best = max(best, cur)
        out.append(best)
    return out


@pytest.mark.parametrize("case", _TRIM_CASES)
def test_ungapped_no_drop_is_the_relu_walk(case):
    """K4's x=None specialisation walks cur = max(cur + s, 0) with PAD at
    -10^6: the twin's restart rule and the reference's give the same."""
    from repro.align.smith_waterman import ungapped_xdrop_scores
    qs, rs = _trim_block(case, len(case) * 7)
    got = ops.ungapped_wave_scores(torch.from_numpy(qs), torch.from_numpy(rs),
                                   x=None)
    np.testing.assert_array_equal(got.numpy(), _ungapped_no_drop_walk(qs, rs))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ungapped_xdrop_scores(qs, rs, x=None)))


@pytest.mark.parametrize("Lq", [1, 31, 32, 33, 127, 129, 255, 257, 511, 513,
                                767, 769, 1023, 1025, 1100, 8192, 8193,
                                34_350])
def test_wave_geometry(Lq):
    """K3's launch geometry: the fewest rows per lane whose strip holds Lq
    (else 32 rows and as many strips as Lq needs: 34 at titin's 34,350),
    shared memory within the card's 227 KB a block, global scratch only
    for multi-strip queries whose strip buffers overflow shared memory."""
    from repro_torch.kernels.sw import (WAVE_RPT, WAVE_SMEM_BUF_MAX,
                                        wave_geometry)
    for Lr in (1, 256, 730, 8192, 20_000):
        for affine in (False, True):
            g = wave_geometry(Lq, Lr, affine)
            assert g.rpt in WAVE_RPT and g.pairs_per_block == 4
            fits = [r for r in WAVE_RPT if 32 * r >= Lq]
            assert g.rpt == (fits[0] if fits else WAVE_RPT[-1])
            assert g.strips == -(-Lq // (32 * g.rpt))
            assert (g.strips > 1) == (Lq > 32 * WAVE_RPT[-1])
            buf = 4 * 4 * Lr * (2 if affine else 1)
            spill = g.strips > 1 and buf > WAVE_SMEM_BUF_MAX
            assert g.scratch_per_pair == (
                (2 if affine else 1) * Lr if spill else 0)
            assert g.smem_bytes == 4 * 21 * 32 * g.rpt + (
                buf if g.strips > 1 and not spill else 0)
            assert g.smem_bytes <= 232_448


@pytest.mark.parametrize("Lr", [1, 31, 32, 33, 128, 129, 383, 384, 385,
                                1023, 1024, 1025, 2048, 2049, 4096, 4097,
                                8192, 8193, 9000, 34_350, 55_296, 55_297,
                                60_000])
def test_rowwave_geometry(Lr):
    """K7's launch geometry: the fewest columns per lane (a multiple of 4)
    whose 32 lanes hold Lr (else 32 and more segments), per warp a
    21 x 32 x cpt int8 profile a segment plus, past one segment, the H row
    and a mask word a lane; 4, 2 or 1 pairs a block, as many as fit the
    card's 227 KB beside the BLOSUM table. Past 8 segments, where one
    pair's buffer does not fit, the whole buffer sits in per-pair global
    scratch, 4 pairs a block. Lq does not enter."""
    from repro_torch.kernels.sw import ROWWAVE_CPT, rowwave_geometry
    g = rowwave_geometry(1, Lr)
    assert all(rowwave_geometry(Lq, Lr) == g for Lq in (384, 8192))
    fits = [c for c in ROWWAVE_CPT if 32 * c >= Lr]
    assert g.cpt == (fits[0] if fits else ROWWAVE_CPT[-1])
    assert g.segments == -(-Lr // (32 * g.cpt))
    assert (g.segments > 1) == (Lr > 32 * ROWWAVE_CPT[-1])
    prof = 21 * 32 * g.cpt * g.segments
    row = (4 * 32 * g.cpt + 4 * 32) * g.segments if g.segments > 1 else 0
    room = 232_448 - 4 * 21 * 21
    assert (g.scratch_per_pair > 0) == (g.segments > 8) == (prof + row > room)
    assert g.scratch_per_pair % 16 == 0
    if g.scratch_per_pair:               # everything in the scratch
        assert g.scratch_per_pair == prof + row
        assert g.smem_bytes == 0 and g.pairs_per_block == 4
        return
    assert g.smem_bytes == g.pairs_per_block * (prof + row)
    assert g.smem_bytes <= room
    assert g.pairs_per_block == 4 or 2 * g.smem_bytes > room


# ------------------------------------------------------------ routing
def test_cpu_tensors_run_the_twins_and_count_no_launch():
    ops.reset_launches()
    qs, rs = _pairs(2, 8, 8, 0)
    q8, r8 = torch.from_numpy(qs), torch.from_numpy(rs)
    ops.wavefront_scores(q8, r8)
    ops.ungapped_wave_scores(q8, r8, x=None)
    ops.sw_rowwave_scores(q8, r8)
    ops.emit_upper_pairs(torch.tensor([[0, 2]]), torch.tensor([[0, 1]]),
                         cap=2)
    q = torch.zeros((2, 1), dtype=torch.int32)
    ops.all_pairs_hamming(q, q)
    assert ops.hamming_counts(q, q, 0).tolist() == [2, 2]
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_meta_device_operands_are_refused():
    q = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.all_pairs_hamming(q, q.to("meta"))
    with pytest.raises(ValueError):
        ops.hamming_counts(q, q.to("meta"), 1)


def test_cuda_operands_launch_k6(monkeypatch):
    """CUDA operands go to K6's launcher and count one launch. With no card
    here, the device check answers CUDA and a stand-in takes the launch,
    so the test sees what the router hands the kernel."""
    from repro_torch.kernels import hamming
    seen = []

    def fake_k6(q, r, *, d):
        seen.append((tuple(q.shape), tuple(r.shape), d))
        return torch.zeros(q.shape[0], dtype=torch.int32)

    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(hamming, "hamming_count", fake_k6)
    ops.reset_launches()
    q = torch.zeros((3, 2), dtype=torch.int32)
    ops.hamming_counts(q, torch.zeros((5, 2), dtype=torch.int32), 2)
    assert seen == [((3, 2), (5, 2), 2)]
    assert ops.LAUNCHES["hamming_count"] == 1
    ops.reset_launches()
