"""Parity of Smith-Waterman scoring at titin's length: a 34,350-residue
query against a 40-residue reference, which the card's K3 (wavefront,
linear and affine) and K7 (row wave) now take, port (CPU: the kernels'
plain twins) against the JAX reference on the same numpy inputs. Integer
scores, exact equality.

The reference's wavefront keeps one lane per query row, so at 34,350
rows its sweep is scored on the pair with its sides swapped (the score
is symmetric: BLOSUM62 and the gaps are), after the Lq = 8,193 case
(``test_torch_long.py``) checks that symmetry on the reference itself;
its row wave runs in the pair's own orientation."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.align import gotoh as j_gotoh
from repro.align.smith_waterman import _sw_scores_batch as j_rowwave

from repro_torch.core.alphabet import PAD
from repro_torch.kernels import ops


def _long_pairs(Lq, Lr, seed):
    """Two pairs: a near copy of the reference planted deep inside the
    query (the best path sits past row 8,192), and a random pair with PAD
    inside and a PAD tail on both sides."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 20, (2, Lq)).astype(np.int8)
    rs = rng.integers(0, 20, (2, Lr)).astype(np.int8)
    at = Lq - Lr - 7
    qs[0, at:at + Lr] = np.where(rng.random(Lr) < 0.1, qs[0, at:at + Lr],
                                 rs[0])
    qs[1, Lq // 2] = PAD
    qs[1, Lq - 5:] = PAD
    rs[1, Lr // 3] = PAD
    rs[1, Lr - 3:] = PAD
    return qs, rs


@pytest.mark.parametrize("Lq,Lr", [(34_350, 40)])
def test_titin_length_scores_match_reference(Lq, Lr):
    qs, rs = _long_pairs(Lq, Lr, Lq + Lr)
    q, r = torch.from_numpy(qs), torch.from_numpy(rs)
    jq, jr = jnp.asarray(qs), jnp.asarray(rs)
    rowwave = np.asarray(j_rowwave(jq, jr))
    lin = ops.wavefront_scores(q, r, gap_mode="linear").numpy()
    aff = ops.wavefront_scores(q, r, gap_mode="affine").numpy()
    np.testing.assert_array_equal(ops.sw_rowwave_scores(q, r).numpy(),
                                  rowwave)
    np.testing.assert_array_equal(lin, rowwave)
    want_lin = np.asarray(j_gotoh.sw_wave_linear(jr, jq))
    want_aff = np.asarray(j_gotoh.sw_wave_affine(jr, jq))
    np.testing.assert_array_equal(lin, want_lin)
    np.testing.assert_array_equal(aff, want_aff)
    assert rowwave[0] > 4 * Lr       # the planted copy scores
    assert aff[0] > 0 and aff[1] > 0
