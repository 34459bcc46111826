"""Parity of the port's job-1 modules (repro_torch.core, .data) with the JAX
reference on the CPU. Inputs come from numpy seeds and go to both
packages; every output is integer, so the tolerance is exact equality."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import alphabet as j_alpha
from repro.core import hamming as j_ham
from repro.core import join as j_join
from repro.core import neighbors as j_nb
from repro.core import shingle as j_sh
from repro.core import simhash as j_sim
from repro.core.pipeline import LSHConfig as JCfg, ScalLoPS as JScalLoPS
from repro.data import synthetic as j_syn

from repro_torch.core import alphabet as t_alpha
from repro_torch.core import hamming as t_ham
from repro_torch.core import join as t_join
from repro_torch.core import neighbors as t_nb
from repro_torch.core import shingle as t_sh
from repro_torch.core import simhash as t_sim
from repro_torch.core.pipeline import LSHConfig as TCfg, ScalLoPS as TScalLoPS
from repro_torch.data import synthetic as t_syn
from repro_torch.util import u32_to_i32


# The reference's eager functions, each jitted whole: one XLA program per
# configuration instead of one per primitive, the same integer results.
_j_extract = jax.jit(j_sh.extract_shingles, static_argnums=2)
_j_shingle_ids = jax.jit(j_sh.shingle_ids)
_j_feature_counts = jax.jit(j_sim.feature_counts, static_argnames=("k", "T"))
_j_band_keys = jax.jit(j_join.band_keys, static_argnums=(1, 2),
                       static_argnames=("interleave", "key_hash"))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _corpus():
    """One corpus for every job-1 test: one set of shapes, so the reference
    traces and compiles each of its programs once per configuration."""
    cfg = dict(n_refs=24, n_homolog_queries=6, n_decoy_queries=2,
               ref_len_mean=60, ref_len_std=20, seed=0)
    return t_syn.make_protein_sets(t_syn.SyntheticProteinConfig(**cfg))


def test_alphabet_tables_and_encoding_match():
    np.testing.assert_array_equal(t_alpha.BLOSUM62, j_alpha.BLOSUM62)
    np.testing.assert_array_equal(t_alpha.BLOSUM62_PADDED,
                                  j_alpha.BLOSUM62_PADDED)
    assert t_alpha.PAD == j_alpha.PAD == 20
    seqs = ["MKTAYIAKQR", "XXBZ", "", "acdefghik"]
    ti, tl = t_alpha.encode_batch(seqs)
    ji, jl = j_alpha.encode_batch(seqs)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_corpus_same_arrays_from_same_seed(seed):
    kw = dict(n_refs=40, n_homolog_queries=9, n_decoy_queries=3,
              ref_len_mean=80, ref_len_std=25, seed=seed)
    t = t_syn.make_protein_sets(t_syn.SyntheticProteinConfig(**kw))
    j = j_syn.make_protein_sets(j_syn.SyntheticProteinConfig(**kw))
    for key in ("ref_ids", "ref_lens", "query_ids", "query_lens"):
        np.testing.assert_array_equal(t[key], j[key])
    assert [p for p, _ in t["truth"]] == [p for p, _ in j["truth"]]


@pytest.mark.parametrize("k", [2, 3])
def test_shingles_and_word_ids_match(k):
    d = _corpus()
    ids, lens = d["ref_ids"], d["ref_lens"]
    tsh, tmask = t_sh.extract_shingles(torch.from_numpy(ids),
                                       torch.from_numpy(lens), k)
    jsh, jmask = _j_extract(ids, lens, k)
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(t_sh.shingle_ids(tsh).numpy(),
                                  np.asarray(_j_shingle_ids(jsh)))


@pytest.mark.parametrize("k", [2, 3])
def test_codebook_and_shingle_rows_match(k):
    np.testing.assert_array_equal(t_nb.codebook(k), j_nb.codebook(k))
    np.testing.assert_array_equal(t_nb.codebook_onehot(k),
                                  j_nb.codebook_onehot(k))
    d = _corpus()
    tsh, _ = t_sh.extract_shingles(torch.from_numpy(d["ref_ids"]),
                                   torch.from_numpy(d["ref_lens"]), k)
    rows = t_nb.shingle_rows(tsh)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(j_nb.shingle_rows(jnp.asarray(tsh.numpy()))))


def test_pack_and_unpack_bits_match():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (7, 3, 64)).astype(bool)
    t = t_sim.pack_bits(torch.from_numpy(bits))
    j = np.asarray(j_sim.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(_u32(t), j)
    np.testing.assert_array_equal(t_sim.unpack_bits(t, 64).numpy(),
                                  np.asarray(j_sim.unpack_bits(j, 64)))


@pytest.mark.parametrize("scheme,f", [("java", 32), ("splitmix", 32),
                                      ("splitmix", 64), ("splitmix", 128)])
@pytest.mark.parametrize("method", ["table", "matmul"])
def test_packed_signatures_match(scheme, f, method):
    d = _corpus()
    cfg = dict(k=3, T=13, f=f, scheme=scheme, siggen_method=method)
    t = TScalLoPS(TCfg(**cfg), device="cpu").signatures(d["ref_ids"],
                                                        d["ref_lens"])
    j = JScalLoPS(JCfg(**cfg)).signatures(d["ref_ids"], d["ref_lens"])
    assert t.dtype == torch.int32 and t.shape == (len(d["ref_lens"]), f // 32)
    np.testing.assert_array_equal(_u32(t), np.asarray(j))


def test_signatures_chunked_equal_whole(monkeypatch):
    """Rows are independent, so the port's host-to-device chunking of job 1
    is bit-exact with one pass over the whole corpus."""
    from repro_torch.core import pipeline
    d = _corpus()
    sl = TScalLoPS(TCfg(k=3, T=13, f=64, scheme="splitmix"), device="cpu")
    whole = sl.signatures(d["ref_ids"], d["ref_lens"])
    counts = sl.feature_counts(d["ref_ids"], d["ref_lens"])
    monkeypatch.setattr(pipeline, "_CHUNK_BYTES", 1)    # one row per chunk
    np.testing.assert_array_equal(
        sl.signatures(d["ref_ids"], d["ref_lens"]).numpy(), whole.numpy())
    np.testing.assert_array_equal(
        sl.feature_counts(d["ref_ids"], d["ref_lens"]).numpy(),
        counts.numpy())


@pytest.mark.parametrize("k,T", [(3, 13), (2, 8)])
def test_feature_counts_match(k, T):
    d = _corpus()
    t = TScalLoPS(TCfg(k=k, T=T), device="cpu").feature_counts(
        d["ref_ids"], d["ref_lens"])
    j = _j_feature_counts(jnp.asarray(d["ref_ids"]),
                          jnp.asarray(d["ref_lens"]), k=k, T=T)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_tables_match():
    np.testing.assert_array_equal(t_sim.java_hash(3), j_sim.java_hash(3))
    np.testing.assert_array_equal(t_sim.hyperplanes(3, 64, "splitmix"),
                                  j_sim.hyperplanes(3, 64, "splitmix"))
    np.testing.assert_array_equal(t_sim.contribution_table(3, 13, 32),
                                  j_sim.contribution_table(3, 13, 32))
    np.testing.assert_array_equal(t_sim.feature_count_table(3, 13),
                                  j_sim.feature_count_table(3, 13))


def test_mix32_matches_on_high_keys():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 1, 2**31, 2**32 - 1]
    t = t_join.mix32(torch.from_numpy(keys.astype(np.int64)))
    j = np.asarray(j_join.mix32(jnp.asarray(keys)))
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


@pytest.mark.parametrize("f,bands,interleave,key_hash", [
    (32, 2, True, "splitmix"),    # the serving default
    (32, 3, False, "none"),       # ragged contiguous bands, raw bits
    (64, 1, True, "splitmix"),    # one 64-bit band: the wide-band fold
    (128, 2, False, "none"),      # 64-bit bands folded, raw
    (64, 4, True, "none"),
])
def test_band_keys_match(f, bands, interleave, key_hash):
    rng = np.random.default_rng(f + bands)
    sigs = rng.integers(0, 2**32, (300, f // 32),
                        dtype=np.uint64).astype(np.uint32)
    t = t_join.band_keys(u32_to_i32(sigs), f, bands, interleave=interleave,
                         key_hash=key_hash)
    j = np.asarray(_j_band_keys(jnp.asarray(sigs), f, bands,
                                interleave=interleave, key_hash=key_hash))
    assert t.dtype == torch.int64 and int(t.min()) >= 0
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


def test_hamming_distance_matches():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2**32, (50, 1, 2), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (1, 70, 2), dtype=np.uint64).astype(np.uint32)
    t = t_ham.hamming_distance(u32_to_i32(a), u32_to_i32(b))
    j = np.asarray(j_ham.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(t.numpy(), j)


def test_lsh_config_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        TCfg(f=48)
    with pytest.raises(ValueError):
        TCfg(f=64, scheme="java")
