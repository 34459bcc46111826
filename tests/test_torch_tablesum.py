"""The ``table_sums`` route of job 1 on the CPU: its wrapper's routing and
refusals, the accumulator choice and the table max behind it, the chunk
plan of the kernel route, and the kernel's algorithm emulated in numpy
against the plain twin.

The kernel itself (``kernels/csrc/tablesum.cu``) runs only on a card
(``tests/test_torch_cuda.py``); the twin is held against the JAX reference
through the pipeline in ``tests/test_torch_core.py``. Outputs are integer:
exact equality.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pipeline import LSHConfig, ScalLoPS
from repro_torch.core.shingle import extract_shingles, shingle_ids
from repro_torch.core.simhash import _device_table, pack_bits
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tablesum
from repro_torch.kernels.tablesum import accumulator_bits


def _inputs(N, L, k, seed):
    """Residues with every edge the kernel meets: lengths 0, < k, = k, = L
    and past L; residues >= 20 (PAD and above) and negative ones inside
    the length."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 20, (N, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, N).astype(np.int64)
    lens[:8] = [0, k - 1, k, L, L + 7, L, L, L]
    ids[5, 1] = 20
    ids[6, 2] = 37
    ids[7, 0] = -3
    for n in range(N):
        ids[n, min(lens[n], L):] = 20
    return ids, lens


def _emulate(ids, lens, table, k):
    """The kernel's walk in numpy: only the positions inside the length are
    visited, each sends its shingle's id (or row W) through the table, and
    the positions past the length add (S - npos) x row W at the end. Sums in
    int64 (the kernel's int32 path is taken only where they fit)."""
    N, L = ids.shape
    W = 20**k
    S = max(L - k + 1, 0)
    t = table.astype(np.int64)
    out = np.zeros((N,) + table.shape[1:], np.int64)
    for n in range(N):
        npos = max(0, min(S, min(max(int(lens[n]), 0), L) - k + 1))
        for pos in range(npos):
            r = ids[n, pos:pos + k].astype(np.int64)
            wid = int((r * 20 ** np.arange(k - 1, -1, -1)).sum())
            out[n] += t[wid if (r < 20).all() and wid >= 0 else W]
        out[n] += (S - npos) * t[W]
    return out


@pytest.mark.parametrize("kind", ["signatures", "counts"])
@pytest.mark.parametrize("k,f", [(2, 32), (3, 64)])
def test_kernel_walk_equals_twin(kind, k, f):
    ids, lens = _inputs(40, 30, k, 7 + k)
    rng = np.random.default_rng(f)
    shape = (20**k + 1, f) if kind == "signatures" else (20**k + 1,)
    table = rng.integers(-500, 500, shape).astype(np.int32)  # row W too
    want = ref.table_sums_ref(torch.from_numpy(ids), torch.from_numpy(lens),
                              torch.from_numpy(table), k=k)
    got = _emulate(ids, lens, table, k)
    if kind == "signatures":
        got = pack_bits(torch.from_numpy(got >= 0))
    else:
        got = torch.from_numpy(got.astype(np.int32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["contrib", "count"])
def test_cpu_tensors_take_the_twin_and_count_no_launch(kind):
    """On the CPU the wrapper runs the twin: the gather, the int64 sum and
    the packing the table route always had."""
    ids, lens = _inputs(30, 25, 3, 1)
    ids, lens = torch.from_numpy(ids), torch.from_numpy(lens)
    table = _device_table(kind, 3, 13, 32, "java", "cpu")
    ops.reset_launches()
    got = ops.table_sums(ids, lens, table)
    assert ops.LAUNCHES["table_sums"] == 0
    wid = shingle_ids(extract_shingles(ids, lens, 3)[0])
    V = torch.sum(table[torch.where(wid >= 0, wid, 8_000)], dim=1)
    want = pack_bits(V >= 0) if kind == "contrib" else V.to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_cuda_operands_launch_table_sums(monkeypatch):
    """CUDA operands go to the kernel's launcher with k from the table's
    rows and count one launch. With no card here, the device check answers
    CUDA and a stand-in takes the launch."""
    from repro_torch.kernels import tablesum
    seen = []

    def fake(ids, lengths, table, *, k):
        seen.append((tuple(ids.shape), tuple(table.shape), k))
        return torch.zeros(ids.shape[0], dtype=torch.int32)

    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(tablesum, "table_sums", fake)
    ops.reset_launches()
    ops.table_sums(torch.zeros((3, 9), dtype=torch.int8),
                   torch.zeros(3, dtype=torch.int32),
                   torch.zeros((20**4 + 1, 64), dtype=torch.int32))
    assert seen == [((3, 9), (160_001, 64), 4)]
    assert ops.LAUNCHES["table_sums"] == 1
    ops.reset_launches()


def _refused():
    ids = torch.zeros((4, 10), dtype=torch.int8)
    lens = torch.full((4,), 10, dtype=torch.int32)
    t = torch.zeros((8_001, 64), dtype=torch.int32)
    return {
        "mixed_devices": ((ids, lens, t.to("meta")), ValueError),
        "int32_ids": ((ids.int(), lens, t), TypeError),
        "noncontiguous_table": ((ids, lens, t[:, ::2]), ValueError),
        "noncontiguous_ids": ((ids.t().contiguous().t(), lens, t), ValueError),
        "rows_not_20_to_k_plus_1": ((ids, lens, t[:8_000]), ValueError),
        "f_not_multiple_of_32": ((ids, lens, t[:, :40].contiguous()),
                                 TypeError),
        "int64_table": ((ids, lens, t.long()), TypeError),
        "lengths_of_other_rows": ((ids, lens[:3], t), ValueError),
        "float_lengths": ((ids, lens.float(), t), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_table_sums_refuses_what_the_kernel_does_not_take(case):
    args, err = _refused()[case]
    with pytest.raises(err):
        ops.table_sums(*args)


def test_accumulator_width_flips_at_the_int32_bound():
    assert accumulator_bits((1 << 31) - 1, 1) == 32
    assert accumulator_bits(1 << 31, 1) == 64
    assert accumulator_bits(2**16, 2**15 - 1) == 32
    assert accumulator_bits(2**16, 2**15) == 64
    # the benchmark's table (k=3, T=13, f=32, splitmix) over 81 residues,
    # and over a titin-long chain: int32 both
    t = _device_table("contrib", 3, 13, 32, "splitmix", "cpu")
    m = max(int(t.max()), -int(t.min()))
    assert accumulator_bits(m, 79) == 32
    assert accumulator_bits(m, 34_348) == 32


def test_table_max_is_read_once_per_table_and_version(monkeypatch):
    """The accumulator's |max| is read from a table once, again after the
    table is written in place, and for each table of its own; a table that
    is gone leaves no entry behind."""
    reads = []
    real_max = torch.Tensor.max

    def counted(t, *a, **kw):
        reads.append(tuple(t.shape))
        return real_max(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "max", counted)
    a = torch.tensor([[3, -9], [4, 1]], dtype=torch.int32)
    b = torch.tensor([[2, 5]], dtype=torch.int32)
    assert tablesum.max_abs(a) == 9 and tablesum.max_abs(a) == 9
    assert reads == [(2, 2)]
    a[0, 0] = -12                       # in place: a new version
    assert tablesum.max_abs(a) == 12 and len(reads) == 2
    assert tablesum.max_abs(b) == 5 and len(reads) == 3
    del b
    assert tablesum.max_abs(a) == 12 and len(reads) == 3
    c = torch.ones((1, 1), dtype=torch.int32)
    assert tablesum.max_abs(c) == 1 and len(reads) == 4
    assert all(h[0]() is not None for h in tablesum._MAX_ABS.values())


@pytest.mark.parametrize("kind", ["signatures", "counts"])
def test_kernel_route_takes_a_read_set_in_one_chunk(kind):
    """On the card the table route budgets only what a row holds there, so
    547,169 reads of 81 residues (and the Swiss-Prot refs, padded to ~805)
    are one chunk; the CPU twin keeps its gather's budget."""
    cfg = LSHConfig(k=3, T=13, f=32, d=1, scheme="splitmix")
    sl = ScalLoPS(cfg, device="cpu")
    twin = sl._chunk_rows(81, kind)
    assert twin == (1 << 30) // (81 * (8 * 32 if kind == "signatures"
                                       else 16))
    if kind == "signatures":            # the twin's 11 chunks
        assert len(range(0, 547_169, twin)) == 11
    sl.device = torch.device("cuda")     # the plan only; nothing runs
    assert sl._chunk_rows(81, kind) >= 547_169
    assert sl._chunk_rows(805, kind) >= 454_401
    assert len(range(0, 547_169, sl._chunk_rows(81, kind))) == 1
    # K1 (the matmul route) keeps its operand's budget for signatures
    sl.cfg = LSHConfig(k=3, T=13, f=32, siggen_method="matmul")
    if kind == "signatures":
        assert sl._chunk_rows(81, kind) == (1 << 30) // (81 * 8 * (32 + 63))
    else:
        assert sl._chunk_rows(81, kind) >= 547_169
