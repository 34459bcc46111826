"""SimHash signature generation (paper §3 / Algorithm 2).

Two mathematically identical paths, as in ``repro/core/simhash.py``:

* ``method="matmul"`` — the paper's structure: score every shingle against
  every codebook word, threshold at T, multiply by the ±1 hyperplanes and
  accumulate V. On CUDA the whole chain is kernel K1
  (``kernels/csrc/siggen.cu``), so the (S, W) score matrix never reaches
  device memory.
* ``method="table"`` (default) — the total contribution of a shingle to V
  depends only on its word id, so ``C[p] = Σ_w [score(p,w) >= T]·score·H[w]``
  is tabulated once per (k, T, f) and signature generation becomes a
  gather + sum over shingle ids.

Packed signatures are (N, f//32) int32 tensors holding the uint32 words of
the reference bit for bit (little-endian bit order within a word).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..obs.jit import trace_sentinel
from ..util import as_unsigned, canonical_device, full_float32_matmul
from .alphabet import ALPHABET_SIZE, AMINO_ACIDS, BLOSUM62_PADDED
from .neighbors import codebook, codebook_onehot, shingle_rows
from .shingle import extract_shingles, shingle_ids

GOLDEN = np.uint64(0x9E3779B97F4A7C15)


# ---------------------------------------------------------------- hash bits
def java_hash(k: int) -> np.ndarray:
    """Java String.hashCode of every codebook word: (W,) int32 (wraparound)."""
    cb = codebook(k)
    chars = np.array([ord(c) for c in AMINO_ACIDS], dtype=np.uint32)
    h = np.zeros(cb.shape[0], dtype=np.uint32)
    for i in range(k):
        h = h * np.uint32(31) + chars[cb[:, i].astype(np.int64)]
    return h.view(np.int32)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + GOLDEN).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@functools.lru_cache(maxsize=16)
def hyperplanes(k: int, f: int, scheme: str = "java") -> np.ndarray:
    """±1 hyperplane matrix H (W, f) int8 — bit j of hash(word) picks the sign."""
    W = ALPHABET_SIZE**k
    if scheme == "java":
        if f > 32:
            raise ValueError("java hashCode provides 32 bits; use scheme='splitmix'")
        h = java_hash(k).view(np.uint32)
        bits = ((h[:, None] >> np.arange(f, dtype=np.uint32)) & 1).astype(np.int8)
    elif scheme == "splitmix":
        n64 = (f + 63) // 64
        ids = np.arange(W, dtype=np.uint64)
        words = np.stack(
            [_splitmix64(ids * np.uint64(n64) + np.uint64(r)) for r in range(n64)],
            axis=-1,
        )
        all_bits = (
            (words[:, :, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
        ).astype(np.int8)
        bits = all_bits.reshape(W, n64 * 64)[:, :f]
    else:
        raise ValueError(f"unknown hash scheme {scheme!r}")
    return (bits * 2 - 1).astype(np.int8)


# ---------------------------------------------------------------- packing
def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., f) bool/int -> (..., f//32) int32 words, little-endian.

    torch's uint32 has no shifts, so each word is built in int64 holding
    the unsigned value and then reinterpreted as int32 bits.
    """
    f = bits.shape[-1]
    if f % 32:
        raise ValueError("f must be a multiple of 32")
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], f // 32, 32)
    shifts = torch.arange(32, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)           # unsigned value, int64
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def unpack_bits(packed: torch.Tensor, f: int) -> torch.Tensor:
    """(..., f//32) int32 words -> (..., f) int32 in {0,1}."""
    shifts = torch.arange(32, device=packed.device)
    w = as_unsigned(packed)[..., :, None] >> shifts
    return (w & 1).to(torch.int32).reshape(*packed.shape[:-1], f)


# ---------------------------------------------------------------- tables
TABLE_BLOCK = 4096   # parent words per block of the per-word tables


@functools.lru_cache(maxsize=8)
def contribution_table(k: int, T: int, f: int, scheme: str = "java") -> np.ndarray:
    """C[p] = Σ_w [score(p,w) >= T]·score(p,w)·H[w] — (W, f) int32.

    Computed blockwise with numpy; float32 BLAS is exact here (|score| <=
    44, |V| < 2^24)."""
    cb_oh = codebook_onehot(k).astype(np.int32)
    cb = codebook(k).astype(np.int64)
    rows = BLOSUM62_PADDED[cb].reshape(cb.shape[0], -1).astype(np.int32)
    H = hyperplanes(k, f, scheme).astype(np.int32)
    W_total = cb.shape[0]
    out = np.zeros((W_total, f), dtype=np.int32)
    blk = TABLE_BLOCK
    rows_f = rows.astype(np.float32)
    cb_f = cb_oh.T.astype(np.float32)
    H_f = H.astype(np.float32)
    for i in range(0, W_total, blk):
        scores = rows_f[i : i + blk] @ cb_f
        wts = np.where(scores >= T, scores, 0.0)
        out[i : i + blk] = (wts @ H_f).astype(np.int32)
    return out


@functools.lru_cache(maxsize=8)
def feature_count_table(k: int, T: int) -> np.ndarray:
    """count[p] = #{w : score(p, w) >= T} — neighbours per parent word."""
    cb_oh = codebook_onehot(k).astype(np.float32)
    cb = codebook(k).astype(np.int64)
    rows = BLOSUM62_PADDED[cb].reshape(cb.shape[0], -1).astype(np.float32)
    W = cb.shape[0]
    out = np.zeros((W,), np.int32)
    blk = TABLE_BLOCK
    for i in range(0, W, blk):
        scores = rows[i:i + blk] @ cb_oh.T
        out[i:i + blk] = (scores >= T).sum(axis=1)
    return out


def table_rows(kind: str, k: int, T: int, f: int, scheme: str,
               device: torch.device, lo: int = 0,
               hi: int | None = None) -> torch.Tensor:
    """Rows ``lo:hi`` of a per-word table built on ``device`` with torch:
    ``kind="contrib"`` gives :func:`contribution_table`'s (hi - lo, f)
    int32 rows, ``kind="count"`` :func:`feature_count_table`'s (hi - lo,)
    int32 counts. The same float32 products in the same 4,096-word blocks
    (from ``lo``) as the numpy tables, and as exact: scores are sums of
    k BLOSUM62 entries, and |V| <= 44 * 20^4 < 2^24 for k <= 4, so every
    partial sum is an integer float32 holds."""
    W = ALPHABET_SIZE**k
    hi = W if hi is None else hi
    cb = codebook(k).astype(np.int64)
    rows = torch.as_tensor(BLOSUM62_PADDED[cb[lo:hi]].reshape(hi - lo, -1),
                           dtype=torch.float32, device=device)
    cbT = torch.as_tensor(codebook_onehot(k), device=device).T.to(
        torch.float32)
    if kind == "contrib":
        H = torch.as_tensor(hyperplanes(k, f, scheme), device=device).to(
            torch.float32)
        out = torch.empty((hi - lo, f), dtype=torch.int32, device=device)
    else:
        out = torch.empty((hi - lo,), dtype=torch.int32, device=device)
    with full_float32_matmul():
        for i in range(0, hi - lo, TABLE_BLOCK):
            scores = rows[i:i + TABLE_BLOCK] @ cbT
            if kind == "contrib":
                wts = torch.where(scores >= T, scores, 0.0)
                out[i:i + TABLE_BLOCK] = (wts @ H).to(torch.int32)
            else:
                out[i:i + TABLE_BLOCK] = (scores >= T).sum(dim=1)
    return out


def _device_table(kind: str, k: int, T: int, f: int, scheme: str,
                  device) -> torch.Tensor:
    """A per-word table on ``device`` with one extra zero row at index W,
    where invalid shingles (id -1) are sent — one gather, no mask pass.
    The CPU's comes from the numpy functions; any other device builds its
    own (:func:`table_rows`: a k=4 table is ~6 TFLOP, a minute and more
    of host time but well under a second on the card). Built once per
    device, whatever its spelling."""
    return _build_table(kind, k, T, f, scheme, canonical_device(device))


@functools.lru_cache(maxsize=16)
@trace_sentinel("device_table")
def _build_table(kind, k, T, f, scheme, device):
    if device.type == "cpu":
        t = torch.from_numpy(contribution_table(k, T, f, scheme)
                             if kind == "contrib"
                             else feature_count_table(k, T))
    else:
        t = table_rows(kind, k, T, f, scheme, device)
    return torch.cat([t, t.new_zeros((1,) + t.shape[1:])])


def _device_siggen_operands(k: int, f: int, scheme: str, device):
    """K1's static operands on ``device``: one-hot codebook (W, D) int8
    and hyperplanes (W, f) int8, uploaded once per device."""
    return _build_siggen_operands(k, f, scheme, canonical_device(device))


@functools.lru_cache(maxsize=8)
@trace_sentinel("siggen_operands")
def _build_siggen_operands(k, f, scheme, device):
    return (torch.as_tensor(codebook_onehot(k), device=device),
            torch.as_tensor(hyperplanes(k, f, scheme), device=device))


def _gather_ids(ids, lengths, k):
    """Shingle word ids with invalid shingles sent to the table's zero
    row W: (N, S) int64."""
    sh, _ = extract_shingles(ids, lengths, k)
    wid = shingle_ids(sh)
    return torch.where(wid >= 0, wid, ALPHABET_SIZE**k)


# ---------------------------------------------------------------- signature gen
def signatures_matmul(ids, lengths, *, k: int, T: int, f: int,
                      scheme: str = "java") -> torch.Tensor:
    """Paper-structure path: V = Σ_shingles thresholded-scores @ H, through
    kernel K1 on CUDA (its plain twin on the CPU).

    Only the valid shingles' BLOSUM rows go to the kernel: a masked row is
    all zero, scores 0 < T against every word and adds nothing, so dropping
    it is exact. Each row's V is then summed into its sequence.

    Args:
      ids: (N, L) int8 padded residues;  lengths: (N,).
    Returns:
      packed signatures (N, f//32) int32.
    """
    from ..kernels import ops

    sh, mask = extract_shingles(ids, lengths, k)
    seq = torch.nonzero(mask)[:, 0]                  # owning sequence per row
    rows = shingle_rows(sh[mask])                    # (R, k*(A+1)) int32
    cb, H = _device_siggen_operands(k, f, scheme, ids.device)
    V = ops.signatures_fused(rows, cb, H, T=T)       # (R, f) int32
    acc = torch.zeros((ids.shape[0], f), dtype=torch.int32, device=ids.device)
    acc.index_add_(0, seq, V)
    return pack_bits(acc >= 0)


def signatures_table(ids, lengths, *, k: int, T: int, f: int,
                     scheme: str = "java") -> torch.Tensor:
    """Beyond-paper path: signature = pack(Σ_s C[shingle_id(s)] >= 0)."""
    Ct = _device_table("contrib", k, T, f, scheme, ids.device)
    V = torch.sum(Ct[_gather_ids(ids, lengths, k)], dim=1)  # (N, f)
    return pack_bits(V >= 0)


def signatures(ids, lengths, *, k: int = 3, T: int = 13, f: int = 32,
               scheme: str = "java", method: str = "table") -> torch.Tensor:
    fn = {"table": signatures_table, "matmul": signatures_matmul}[method]
    return fn(ids, lengths, k=k, T=T, f=f, scheme=scheme)


def feature_counts(ids, lengths, *, k: int, T: int) -> torch.Tensor:
    """Per-sequence total neighbour-feature count (N,) int32. Sequences
    with zero features collapse to the all-ones fingerprint and are
    filtered by the paper's non-zero-signature rule (§5.2)."""
    table = _device_table("count", k, T, 0, "java", ids.device)
    return torch.sum(table[_gather_ids(ids, lengths, k)], dim=1).to(
        torch.int32)
