"""K5's index math, written in torch (``kernels/spgemm.py``
``upper_pairs_by_bucket``: the bucket bases and the slot -> (bucket, i, j)
map of ``csrc/spgemm.cu``), held slot for slot against K5's twin
``upper_pairs_ref`` and the Pallas kernel (interpret mode, as the
reference's tests run it) on random slabs: padded slabs, an empty band,
entries before the first offset, one bucket of 3,000 entries, and caps
below and above the band totals. Integer outputs, exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.spgemm import upper_pairs_kernel

from repro_torch.kernels.ref import upper_pairs_ref
from repro_torch.kernels.spgemm import (bucket_bases, triangle_rows,
                                        upper_pairs_by_bucket)


def _slabs(rng, nb, U, E, pad_u, pad_e, empty_band, lead=0):
    """Band-stacked CSR slabs, padded as the partition pads them (offsets
    repeat the end, ids pad with 0); ``lead`` entries before the first
    offset (the reference puts them in a bucket of their own)."""
    offs = np.zeros((nb, U + pad_u + 1), np.int32)
    ids = np.zeros((nb, E + pad_e), np.int32)
    for b in range(nb):
        if empty_band and b == 0:
            continue
        o = np.concatenate([[0], np.sort(rng.integers(0, E, U - 1)), [E]])
        o[0] = min(lead, o[1])
        offs[b, :U + 1] = o
        offs[b, U + 1:] = E
        ids[b, :E] = rng.permutation(E)
    return offs, ids


def _total(offs):
    return max(int(bucket_bases(torch.from_numpy(o))[3]) for o in offs)


@pytest.mark.parametrize("pad_u,pad_e,empty_band,lead", [
    (0, 0, False, 0), (8, 32, False, 0), (0, 0, True, 0), (3, 5, False, 4)])
def test_bucket_index_matches_twin_and_pallas(pad_u, pad_e, empty_band,
                                              lead):
    rng = np.random.default_rng(11 + pad_u + 2 * empty_band + lead)
    offs, ids = _slabs(rng, 3, 8, 40, pad_u, pad_e, empty_band, lead)
    total = _total(offs)
    o, i = torch.from_numpy(offs), torch.from_numpy(ids)
    for cap in (32, 512):                 # below and above the totals
        assert (cap < total) == (cap == 32)
        got = upper_pairs_by_bucket(o, i, cap=cap).numpy()
        np.testing.assert_array_equal(got, upper_pairs_ref(o, i,
                                                           cap=cap).numpy())
        kern = upper_pairs_kernel(jnp.asarray(offs), jnp.asarray(ids),
                                  cap=cap, slot_block=32, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(kern))


def test_bucket_index_one_bucket_of_3000():
    """One bucket of 3,000 entries (4,498,500 pairs, rows of the triangle
    from 2,999 slots down to 1) beside small ones: every slot against the
    twin with the cap above the total, and the first slots against the
    Pallas kernel with a cap below it."""
    rng = np.random.default_rng(5)
    E = 3100
    offs = np.array([[0, 40, 3040, 3041, 3100, 3100]], np.int32)
    ids = rng.permutation(E).astype(np.int32)[None]
    o, i = torch.from_numpy(offs), torch.from_numpy(ids)
    total = _total(offs)
    assert total == 780 + 4_498_500 + 1711
    got = upper_pairs_by_bucket(o, i, cap=1 << 23)
    want = upper_pairs_ref(o, i, cap=1 << 23)
    assert torch.equal(got, want)
    assert int((got[0, :, 0] >= 0).sum()) == total
    kern = upper_pairs_kernel(jnp.asarray(offs), jnp.asarray(ids), cap=2048,
                              slot_block=1024, interpret=True)
    np.testing.assert_array_equal(
        upper_pairs_by_bucket(o, i, cap=2048).numpy(), np.asarray(kern))


def test_triangle_rows_closed_form():
    """The closed form with its correction steps gives the row of every
    slot of triangles up to n = 3,000, and of the last slots of the
    largest bucket a band could hold (n = E = 2^31 - 1 entries)."""
    for n in (2, 3, 4, 7, 64, 3000):
        i = np.repeat(np.arange(n - 1), np.arange(n - 1, 0, -1))
        t = torch.arange(n * (n - 1) // 2)
        got = triangle_rows(t, torch.full_like(t, n))
        np.testing.assert_array_equal(got.numpy(), i)
    n = (1 << 31) - 1
    tri = n * (n - 1) // 2
    t = torch.tensor([0, n - 2, n - 1, tri - 3, tri - 2, tri - 1])
    got = triangle_rows(t, torch.full_like(t, n)).tolist()
    assert got == [0, 0, 1, n - 3, n - 3, n - 2]
