"""Parity of the port's SpGEMM candidate generation and pack tail with the
JAX reference: the delta join over several segments, the fused in-join
prefilter, the keyed dup-free join against the sort-dedup join (and the
wide-id route that corpora above ``PACKED_KEY_MAX_ID`` take), the pack's
wide-id fallback, and the upper-mask emission (kernel K5's twin) against
the Pallas kernel in interpret mode and the host oracle. Exact equality
throughout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.allpairs import JoinPrefilter as JPrefilter
from repro.allpairs import lsh_delta_join as j_delta
from repro.allpairs import lsh_self_join as j_join
from repro.core import LSHConfig as JCfg
from repro.core.join import pack_unique_pairs as j_pack
from repro.index import SignatureIndex as JIndex
from repro.index.spgemm import spgemm_join_self as j_join_self
from repro.kernels.ref import spgemm_upper_ref
from repro.kernels.spgemm import upper_pairs_kernel

from repro_torch.allpairs import (JoinPrefilter, lsh_delta_join,
                                  lsh_self_join)
from repro_torch.core.join import (PACKED_KEY_MAX_ID, compact_pairs,
                                   dedup_pairs, pack_unique_pairs)
from repro_torch.core.pipeline import LSHConfig
from repro_torch.data.synthetic import FamilyCorpusConfig, make_family_corpus
from repro_torch.index.spgemm import (masked_pair_product, spgemm_join_self,
                                      spgemm_join_self_keys)
from repro_torch.index.store import SignatureIndex
from repro_torch.kernels import ops
from repro_torch.util import next_pow2

KW = dict(k=3, T=13, f=32, d=1)


@pytest.fixture(scope="module")
def corpus():
    return make_family_corpus(FamilyCorpusConfig(
        n_families=12, family_size=3, n_singletons=36, len_mean=90,
        len_std=12, sub_rate=0.04, seed=11))


@pytest.fixture(scope="module")
def index(corpus):
    return SignatureIndex.build(LSHConfig(**KW), corpus["ids"],
                                corpus["lens"], device="cpu")


def test_delta_join_matches_reference(corpus):
    """Two sealed segments over a resident one: the delta (within masks
    through K5's twin, cross masks) equals the reference's delta, and its
    union with the old pairs is the from-scratch join."""
    ids, lens = corpus["ids"], corpus["lens"]
    n = len(lens)
    base = n - 24
    t_idx = SignatureIndex.build(LSHConfig(**KW), ids[:base], lens[:base],
                                 device="cpu")
    j_idx = JIndex.build(JCfg(**KW), ids[:base], lens[:base])
    old = lsh_self_join(t_idx)
    j_join(j_idx)
    for a, b in ((base, n - 12), (n - 12, n)):
        t_idx.add(ids[a:b], lens[a:b])
        j_idx.add(ids[a:b], lens[a:b])
    for d in (None, 1):
        delta = lsh_delta_join(t_idx, base_size=base, d=d)
        np.testing.assert_array_equal(
            delta.pairs, j_delta(j_idx, base_size=base, d=d).pairs)
    delta = lsh_delta_join(t_idx, base_size=base)
    full = lsh_self_join(SignatureIndex.build(LSHConfig(**KW), ids, lens,
                                              device="cpu"))
    union = np.concatenate([old.pairs, delta.pairs], axis=0)
    union = union[np.lexsort((union[:, 1], union[:, 0]))]
    np.testing.assert_array_equal(union, full.pairs)
    assert lsh_delta_join(t_idx, base_size=n).n_candidates == 0
    with pytest.raises(ValueError, match="segment boundary"):
        lsh_delta_join(t_idx, base_size=base + 1)


def test_prefilter_fused_matches_reference(corpus, index):
    kw = dict(ids=corpus["ids"], lens=corpus["lens"], min_score=20)
    got = lsh_self_join(index, prefilter=JoinPrefilter(**kw))
    want = j_join(JIndex.build(JCfg(**KW), corpus["ids"], corpus["lens"]),
                  prefilter=JPrefilter(**kw))
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.ungapped, want.ungapped)
    assert got.n_prefiltered == want.n_prefiltered > 0
    with pytest.raises(ValueError, match="min_score"):
        lsh_self_join(index, prefilter=JoinPrefilter(
            ids=corpus["ids"], lens=corpus["lens"], min_score=0))


def _slabs(index):
    part = index.partition(1)
    _, offs_s, ids_s = part.device_slabs()
    return (offs_s.reshape(-1, offs_s.shape[-1]),
            ids_s.reshape(-1, ids_s.shape[-1]),
            next_pow2(int(part.pair_totals.max())),
            next_pow2(int(part.pair_totals.sum())), offs_s.shape)


def test_keyed_join_matches_dedup_join(index):
    """The keyed dup-free join and the sort-dedup join give identical
    pairs and counts off the same slabs, and the reference's."""
    offs_f, ids_f, cap, out_cap, shape = _slabs(index)
    band_f = torch.arange(shape[1]).repeat(shape[0])
    for d in (None, 1):
        p1, c1 = spgemm_join_self(offs_f, ids_f, index.device_sigs,
                                  cap=cap, out_cap=out_cap, d=d)
        p2, c2 = spgemm_join_self_keys(offs_f, ids_f, band_f,
                                       index.device_band_keys,
                                       index.device_sigs, cap=cap,
                                       out_cap=out_cap, d=d)
        assert int(c1) == int(c2)
        np.testing.assert_array_equal(p1.numpy(), p2.numpy())
        p3, c3 = j_join_self(jnp.asarray(offs_f.numpy()),
                             jnp.asarray(ids_f.numpy()),
                             jnp.asarray(index.sigs), cap=cap,
                             out_cap=out_cap, d=d)
        assert int(c3) == int(c1)
        np.testing.assert_array_equal(np.asarray(p3), p1.numpy())


def test_join_self_wide_id_route(index):
    """``spgemm_join_self`` past PACKED_KEY_MAX_ID (the route a myva-scale
    corpus takes): signatures padded to 46,341 rows force the wide
    dedup, with and without the Hamming filter; same output as the
    reference's wide route and as the packed route on the real rows."""
    offs_f, ids_f, cap, out_cap, _ = _slabs(index)
    wide = np.zeros((PACKED_KEY_MAX_ID + 1, index.sigs.shape[1]), np.uint32)
    wide[:index.size] = index.sigs
    wide_t = torch.from_numpy(wide.view(np.int32))
    for d in (None, 1):
        got, n1 = spgemm_join_self(offs_f, ids_f, wide_t, cap=cap,
                                   out_cap=out_cap, d=d)
        small, n2 = spgemm_join_self(offs_f, ids_f, index.device_sigs,
                                     cap=cap, out_cap=out_cap, d=d)
        want, n3 = j_join_self(jnp.asarray(offs_f.numpy()),
                               jnp.asarray(ids_f.numpy()),
                               jnp.asarray(wide), cap=cap,
                               out_cap=out_cap, d=d)
        assert int(n1) == int(n2) == int(n3) > 0
        np.testing.assert_array_equal(got.numpy(), small.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("out_cap", [128, 512])
def test_pack_unique_pairs_wide_id_fallback(out_cap):
    """Ids past PACKED_KEY_MAX_ID take dedup_pairs + compact_pairs: the
    packed route's output, and the reference's, truncation included."""
    rng = np.random.default_rng(3)
    cand = rng.integers(0, 50, size=(256, 2), dtype=np.int32)
    cand.sort(axis=1)
    cand[rng.random(256) < 0.3] = -1
    c = torch.from_numpy(cand)
    packed, n1 = pack_unique_pairs(c, out_cap=out_cap, id_bound=50)
    wide, n2 = pack_unique_pairs(c, out_cap=out_cap,
                                 id_bound=PACKED_KEY_MAX_ID + 1)
    want, n3 = j_pack(jnp.asarray(cand), out_cap=out_cap, id_bound=50)
    assert int(n1) == int(n2) == int(n3)
    np.testing.assert_array_equal(packed.numpy(), wide.numpy())
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    cs, keep = dedup_pairs(c)
    ref, n4 = compact_pairs((cs[:, 0], cs[:, 1]), keep, out_cap)
    assert int(n4) == int(n1)
    np.testing.assert_array_equal(ref.numpy(), packed.numpy())
    small, n5 = pack_unique_pairs(c, out_cap=8, id_bound=50)   # truncates
    assert int(n5) == int(n1) > 8
    np.testing.assert_array_equal(small.numpy(), packed.numpy()[:8])


def _random_slabs(rng, nb, U, E, pad_u, pad_e, empty_band):
    offs = np.zeros((nb, U + pad_u + 1), np.int32)
    ids = np.zeros((nb, E + pad_e), np.int32)
    for b in range(nb):
        if empty_band and b == 0:
            continue
        cuts = np.sort(rng.integers(0, E, U - 1))
        offs[b, :U + 1] = np.concatenate([[0], cuts, [E]])
        offs[b, U + 1:] = E
        ids[b, :E] = rng.permutation(E)
    need = max(int((np.diff(o) * (np.diff(o) - 1) // 2).sum())
               for o in offs)
    return offs, ids, next_pow2(max(need, 8))


@pytest.mark.parametrize("pad_u,pad_e,empty_band", [
    (0, 0, False), (8, 32, False), (0, 0, True)])
def test_upper_pairs_twin_matches_pallas_kernel(pad_u, pad_e, empty_band):
    """K5's twin, the Pallas upper-mask kernel (interpret mode, as the
    reference tests run it) and the host-loop oracle agree slot for slot
    on random multi-band slabs: padded slabs and an empty band too."""
    rng = np.random.default_rng(7 + pad_u + empty_band)
    offs, ids, cap = _random_slabs(rng, 3, 8, 32, pad_u, pad_e, empty_band)
    got = ops.emit_upper_pairs(torch.from_numpy(offs), torch.from_numpy(ids),
                               cap=cap).numpy()
    kern = np.asarray(upper_pairs_kernel(jnp.asarray(offs), jnp.asarray(ids),
                                         cap=cap, slot_block=8,
                                         interpret=True))
    np.testing.assert_array_equal(got, kern)
    for b in range(3):
        np.testing.assert_array_equal(got[b],
                                      spgemm_upper_ref(offs[b], ids[b], cap))
        np.testing.assert_array_equal(
            got[b], masked_pair_product(torch.from_numpy(offs[b]),
                                        torch.from_numpy(ids[b]),
                                        cap=cap).numpy())
