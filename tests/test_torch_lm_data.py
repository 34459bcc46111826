"""The port's LM token pipeline (``repro_torch.data.lm_data``) against
the reference's: ``token_signatures`` bit for bit (the port's int32
words are the reference's uint32 bits), ``dedup_corpus``'s keep masks
and counts equal, ``synth_corpus`` identical (numpy in both), and the
reference's own tests of the pipeline mirrored. ``lm_batches`` draws
torch's numbers (a generator seeded from (seed, step, shard)), not
``jax.random``'s, so its tests check its contract, not its values."""
import numpy as np
import pytest
import torch

from repro.data import lm_data as J
from repro_torch.data.lm_data import (LMDataConfig, dedup_corpus,
                                      lm_batches, synth_corpus,
                                      token_signatures)

CPU = torch.device("cpu")


def _ragged(n, L, vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    lens[:3] = (L, 2, 0)
    for i, m in enumerate(lens):
        toks[i, m:] = -1                                   # PAD
    return toks, lens


@pytest.mark.parametrize("k,f", [(4, 64), (4, 128), (8, 64), (8, 128)])
def test_token_signatures_bit_exact(k, f):
    toks, lens = _ragged(48, 60, 50_000, seed=k * f)
    want = np.asarray(J.token_signatures(toks, lens, k=k, f=f))
    got = token_signatures(toks, lens, k=k, f=f, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (48, f // 32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_synth_corpus_identical():
    for seed, dup in ((0, 0.1), (4, 0.25)):
        jc = J.LMDataConfig(vocab_size=1000, seq_len=128, global_batch=8,
                            seed=seed)
        tc = LMDataConfig(vocab_size=1000, seq_len=128, global_batch=8,
                          seed=seed)
        for a, b in zip(J.synth_corpus(jc, 96, dup), synth_corpus(tc, 96, dup)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_dedup_corpus_matches_reference():
    cfg = LMDataConfig(vocab_size=256, seq_len=128, global_batch=8)
    docs, lens = synth_corpus(cfg, n_docs=256, dup_fraction=0.1)
    want_keep, want_n = J.dedup_corpus(docs, lens)
    keep, n = dedup_corpus(docs, lens, device=CPU)
    assert n == want_n and n > 0
    np.testing.assert_array_equal(keep, want_keep)
    # from a capacity that every band overruns (each document meets itself
    # in each band), the join grows until it fits: the same answer
    keep16, n16 = dedup_corpus(docs, lens, max_pairs=16, device=CPU)
    assert n16 == n
    np.testing.assert_array_equal(keep16, keep)


def test_dedup_drops_planted_twins():
    cfg = LMDataConfig(vocab_size=1000, seq_len=128, global_batch=8, seed=4)
    docs, lens = synth_corpus(cfg, n_docs=64, dup_fraction=0.25)
    keep, n_dups = dedup_corpus(docs, lens, k=4, f=128, d=28, device=CPU)
    # 16 planted twins; most are caught with no clean-doc collateral
    assert n_dups >= 14
    assert keep[:48].all()  # originals all kept (twins occupy the tail)


def test_lm_batches_deterministic_and_sharded():
    cfg = LMDataConfig(vocab_size=512, seq_len=16, global_batch=8, seed=5)
    a1, t1 = lm_batches(cfg, step=7, shard=0, n_shards=2, device=CPU)
    a2, t2 = lm_batches(cfg, step=7, shard=0, n_shards=2, device=CPU)
    b, _ = lm_batches(cfg, step=7, shard=1, n_shards=2, device=CPU)
    c, _ = lm_batches(cfg, step=8, shard=0, n_shards=2, device=CPU)
    assert torch.equal(a1, a2) and torch.equal(t1, t2)
    assert not torch.equal(a1, b) and not torch.equal(a1, c)
    assert a1.shape == t1.shape == (4, 16) and a1.dtype == torch.int32
    assert torch.equal(a1[:, 1:], t1[:, :-1])        # targets shifted by one
    assert 0 <= int(a1.min()) and int(t1.max()) < 512
    other = LMDataConfig(vocab_size=512, seq_len=16, global_batch=8, seed=6)
    assert not torch.equal(lm_batches(other, 7, shard=0, n_shards=2,
                                      device=CPU)[0], a1)
