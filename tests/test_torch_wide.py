"""Parity at signature widths past 256 bits (f = 288 and 512: 9 and 16
words), which the card's K2 and K6 now take on their chunked paths: the
dense top-k and the dense join, port (CPU: the kernels' plain twins)
against the JAX reference on the same numpy inputs. Integer outputs,
exact equality. The matmul signature path (K1) at these widths is in
``test_torch_wide_siggen.py``."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core import hamming as j_ham
from repro.core.pipeline import LSHConfig as JCfg
from repro.index import service as j_svc
from repro.index.store import SignatureIndex as JIndex

from repro_torch.core import hamming as t_ham
from repro_torch.index import service as t_svc
from repro_torch.index.interop import index_from_arrays
from repro_torch.kernels import ops
from repro_torch.util import u32_to_i32

WIDTHS = [288, 512]
_j_dense = jax.jit(j_ham.threshold_pairs, static_argnums=(2, 3))


def _near(rng, Q, R, nw, flips=3):
    """Refs, and queries 0..flips-1 bits from random refs."""
    r = rng.integers(0, 2**32, (R, nw), dtype=np.uint64).astype(np.uint32)
    q = r[rng.integers(0, R, Q)].copy()
    for i in range(Q):
        for b in range(i % flips):
            q[i, (7 * b + i) % nw] ^= np.uint32(1) << np.uint32((5 * i + b) % 32)
    return q, r


def _exported(j):
    j.seal()
    return dict(cfg_dict=dataclasses.asdict(j.cfg), sigs=j.sigs,
                valid=j.valid, segments_csr=[s.csr for s in j.segments],
                layout=j.layout, bands=j.bands, interleave=j.interleave,
                key_hash=j.key_hash)


@pytest.mark.parametrize("f", WIDTHS)
def test_topk_dense_wide(f):
    """The dense top-k (K2's path) over an index of f-bit signatures, with
    ties at the cut and invalid refs."""
    rng = np.random.default_rng(f)
    q, r = _near(rng, 8, 150, f // 32)
    r[40:60] = r[40]                     # a tie group of 20
    q[0] = r[40]
    valid = rng.random(150) > 0.1
    j = JIndex(JCfg(k=3, T=13, f=f, d=2, scheme="splitmix"), r, valid)
    t = index_from_arrays(**_exported(j), device="cpu")
    for k in (5, 30):
        tid, tdist = t_svc.topk_dense(t, u32_to_i32(q), k=k)
        jid, jdist = j_svc.topk_dense(j, q, k=k)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("max_pairs", [512, 7])
def test_threshold_pairs_wide(f, max_pairs):
    """The dense join (K6 counts, K2 emission) at d = 2, with a buffer that
    holds every hit and one that truncates."""
    rng = np.random.default_rng(f + max_pairs)
    q, r = _near(rng, 30, 40, f // 32)
    got = t_ham.threshold_pairs(u32_to_i32(q), u32_to_i32(r), 2, max_pairs)
    want = _j_dense(jnp.asarray(q), jnp.asarray(r), 2, max_pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts = ops.hamming_counts(u32_to_i32(q), u32_to_i32(r), 2)
    assert int(counts.sum()) == int(got[1]) > max_pairs or max_pairs == 512


