"""The port's CUDA kernels against their plain torch twins, on the card.

The kernels (K1 siggen, K2 dense Hamming, K3 wavefront SW, K4 ungapped
X-drop, K5 SpGEMM pair emission, K7 row-wave SW) have no CPU or interpret
mode, so every test here is marked ``cuda`` and skips where there is no
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


@pytest.mark.cuda
def test_siggen_kernel_matches_twin_on_card(cuda_device):
    t = [a.to(cuda_device) for a in _siggen_inputs(1000, 3, 64, 11)]
    ops.reset_launches()
    ops.RECORDED = {}
    try:
        got = ops.signatures_fused(*t, T=13)
        ops.signatures_fused(*t, T=14)
        recorded = ops.RECORDED
    finally:
        ops.RECORDED = None
    assert ops.LAUNCHES["siggen_accumulate"] == 2
    args, kw = recorded["siggen_accumulate"]        # the first launch only
    assert kw == {"T": 13} and all(torch.equal(a, b) for a, b in zip(args, t))
    np.testing.assert_array_equal(
        got.cpu().numpy(), ref.siggen_accumulate_ref(*t, 13).cpu().numpy())


@pytest.mark.cuda
def test_hamming_kernel_matches_twin_on_card(cuda_device):
    rng = np.random.default_rng(12)
    q = u32_to_i32(rng.integers(0, 2**32, (70, 2), dtype=np.uint64)
                   .astype(np.uint32)).to(cuda_device)
    r = u32_to_i32(rng.integers(0, 2**32, (1000, 2), dtype=np.uint64)
                   .astype(np.uint32)).to(cuda_device)
    np.testing.assert_array_equal(ops.all_pairs_hamming(q, r).cpu().numpy(),
                                  ref.hamming_dist_ref(q, r).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("gap_mode", ["linear", "affine"])
@pytest.mark.parametrize("Lq", [40, 300, 1100])
def test_wave_kernel_matches_twin_on_card(cuda_device, gap_mode, Lq):
    qs, rs = _pairs(9, Lq, 250, Lq)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    got = ops.wavefront_scores(q, r, gap_mode=gap_mode)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        ops.wavefront_scores(q.cpu(), r.cpu(), gap_mode=gap_mode).numpy())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((4, 9), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):          # more than 8 words
        ops.all_pairs_hamming(q, q)
    with pytest.raises(TypeError):           # int64 signature words
        ops.all_pairs_hamming(q.long(), q.long())
    s = torch.zeros((2, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):          # not contiguous
        ops.wavefront_scores(s.t().contiguous().t(), s)
    with pytest.raises(ValueError):          # CPU and CUDA mixed
        ops.wavefront_scores(s, s.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("x", [None, 10, 0])
@pytest.mark.parametrize("Lq", [40, 300, 1100])
def test_ungapped_kernel_matches_twin_on_card(cuda_device, x, Lq):
    """Ragged PAD tails, an all-PAD last row, finite and no X-drop."""
    qs, rs = _pairs(9, Lq, 250, Lq + 1)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    got = ops.ungapped_wave_scores(q, r, x=x)
    want = ops.ungapped_wave_scores(q.cpu(), r.cpu(), x=x)
    assert int(want[-1]) == 0
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lr", [(40, 30), (300, 250), (250, 300),
                                   (100, 1100)])
def test_rowwave_kernel_matches_twin_and_wavefront_on_card(cuda_device, Lq,
                                                           Lr):
    qs, rs = _pairs(9, Lq, Lr, Lq * 7 + Lr)
    q, r = torch.from_numpy(qs).to(cuda_device), torch.from_numpy(rs).to(
        cuda_device)
    ops.reset_launches()
    got = ops.sw_rowwave_scores(q, r)
    assert ops.LAUNCHES["sw_rowwave"] == 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), ops.sw_rowwave_scores(q.cpu(), r.cpu()).numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(), ops.wavefront_scores(q, r).cpu().numpy())


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
