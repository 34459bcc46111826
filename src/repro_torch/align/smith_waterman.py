"""Smith-Waterman scoring of gathered pair blocks, the ungapped X-drop
prefilter and the percent-identity traceback.

``sw_gather_scores`` gathers both sides of each (query, reference) pair
from device-resident corpora and scores the block with one DP sweep:

* ``dp_kernel="wavefront"`` (default) — the anti-diagonal sweep, linear or
  affine gaps: kernel K3 on CUDA (``kernels/csrc/sw.cu``), its plain twin
  (``align/gotoh.py``) on the CPU;
* ``dp_kernel="rowwave"`` — the linear-gap row wave, each row resolved by a
  max-plus prefix scan (H[i, 1:] = cummax(A + c*t) - c*t, c = -GAP):
  kernel K7 on CUDA, its twin (``kernels/ref.py``) on the CPU.

``ungapped_xdrop_scores`` is the all-pairs prefilter (kernel K4 on CUDA).
``sw_wave_pid`` computes the row wave's DP matrices with plain torch on
the blocks' device, as the reference computes them with jnp outside any
Pallas kernel, and runs the traceback on the host: no kernel is ported
for it.

The paper's quality evaluation (§5.2) calls the pair API: ``sw_score``,
``sw_align_batch`` and ``sw_scores_device`` score with the row wave
(kernel K7 on the card); ``percent_identity`` and
``batch_percent_identity`` trace back the best local alignment of each
pair. They run on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.alphabet import BLOSUM62_PADDED, PAD
from ..util import resolve_device

GAP = -4     # linear gap penalty (BLOSUM62-compatible default)
NEG = -10**6  # masked-substitution sentinel (padded positions never win)


def _sub_matrix(qs: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """(B, Lq) x (B, Lr) int8 -> (B, Lq, Lr) int32 substitution scores,
    PAD-masked with NEG."""
    table = torch.as_tensor(BLOSUM62_PADDED, device=qs.device)
    q = qs.to(torch.int64)
    r = rs.to(torch.int64)
    sub = table[q[:, :, None], r[:, None, :]]
    valid = (q != PAD)[:, :, None] & (r != PAD)[:, None, :]
    return torch.where(valid, sub, NEG)


def rowwave_rows(qs: torch.Tensor, rs: torch.Tensor, *, gap: int = GAP):
    """The linear-gap row wave: yields H[i, :] (B, Lr+1) int32 for
    i = 1..Lq of each pair of a (B, Lq) x (B, Lr) block, each row one
    max-plus prefix scan of the row before."""
    B, Lq = qs.shape
    Lr = rs.shape[1]
    sub = _sub_matrix(qs, rs)
    c = -gap
    t = torch.arange(1, Lr + 1, dtype=torch.int32, device=qs.device)
    prev = torch.zeros((B, Lr + 1), dtype=torch.int32, device=qs.device)
    zcol = prev[:, :1]
    for i in range(Lq):
        a = torch.maximum(prev[:, :-1] + sub[:, i], prev[:, 1:] + gap)
        a = a.clamp_min(0)
        p = torch.cummax(a + c * t, dim=1).values
        prev = torch.cat([zcol, p - c * t], dim=1)
        yield prev


def gather_rows(ids_dev: torch.Tensor, lens_dev: torch.Tensor,
                idx: torch.Tensor, L: int) -> torch.Tensor:
    """(N, Lmax) device corpus -> (B, L) PAD-masked block for row indices
    ``idx`` (idx < 0 marks padding slots -> all-PAD rows)."""
    safe = idx.clamp_min(0)
    rows = ids_dev[safe, :min(L, ids_dev.shape[1])]
    if rows.shape[1] < L:       # padded ladder exceeds the corpus width
        rows = torch.nn.functional.pad(rows, (0, L - rows.shape[1]),
                                       value=PAD)
    ln = torch.where(idx >= 0, lens_dev[safe], 0)
    pos = torch.arange(L, device=ids_dev.device)[None, :]
    return torch.where(pos < ln[:, None], rows, PAD).contiguous()


def dp_scores_block(qm, rm, *, dp_kernel: str = "wavefront",
                    gap_mode: str = "linear", gap_open: int | None = None,
                    gap_extend: int | None = None) -> torch.Tensor:
    """Route a gathered (B, Lq) x (B, Lr) pair block to a DP sweep."""
    from ..kernels import ops

    if gap_mode not in ("linear", "affine"):
        raise ValueError(f"unknown gap_mode {gap_mode!r}")
    if dp_kernel not in ("wavefront", "rowwave"):
        raise ValueError(f"unknown dp_kernel {dp_kernel!r}")
    if gap_mode == "affine" and dp_kernel == "rowwave":
        raise ValueError("affine gaps need dp_kernel='wavefront' (the row "
                         "wave's prefix-scan closed form only holds for "
                         "linear penalties)")
    if dp_kernel == "rowwave":
        return ops.sw_rowwave_scores(qm, rm)
    return ops.wavefront_scores(qm, rm, gap_mode=gap_mode,
                                gap_open=gap_open, gap_extend=gap_extend)


def sw_gather_scores(q_ids, q_lens, r_ids, r_lens, qi, ri, *,
                     Lq: int, Lr: int, dp_kernel: str = "wavefront",
                     gap_mode: str = "linear", gap_open: int | None = None,
                     gap_extend: int | None = None) -> torch.Tensor:
    """Gather both pair sides from device-resident corpora and score them.
    (qi, ri) (B,) with -1 padding; padding slots score 0."""
    qm = gather_rows(q_ids, q_lens, qi, Lq)
    rm = gather_rows(r_ids, r_lens, ri, Lr)
    return dp_scores_block(qm, rm, dp_kernel=dp_kernel, gap_mode=gap_mode,
                           gap_open=gap_open, gap_extend=gap_extend)


def ungapped_xdrop_scores(qs: torch.Tensor, rs: torch.Tensor, *,
                          x: int | None = None) -> torch.Tensor:
    """Batched ungapped X-drop scores: (B, Lq) x (B, Lr) int8 -> (B,)
    int32 on the blocks' device (kernel K4 on CUDA). ``x=None`` disables
    the drop test (plain best ungapped segment). Always a lower bound of
    the gapped SW score, so thresholding on it never adds pairs."""
    from ..kernels import ops
    return ops.ungapped_wave_scores(qs, rs, x=x)


def _traceback_pid(H: np.ndarray, q: np.ndarray, r: np.ndarray,
                   sub: np.ndarray) -> tuple[float, int]:
    """Host traceback from argmax(H): returns (PID %, alignment length)."""
    i, j = np.unravel_index(np.argmax(H), H.shape)
    ident = 0
    length = 0
    while i > 0 and j > 0 and H[i, j] > 0:
        h = H[i, j]
        if h == H[i - 1, j - 1] + sub[i - 1, j - 1]:
            ident += int(q[i - 1] == r[j - 1])
            length += 1
            i, j = i - 1, j - 1
        elif h == H[i - 1, j] + GAP:
            length += 1
            i -= 1
        else:
            length += 1
            j -= 1
    return (100.0 * ident / max(length, 1), length)


def _sw_batch_with_matrix(qs: torch.Tensor, rs: torch.Tensor):
    """(best (B,) int32, H (B, Lq+1, Lr+1) int32) of a pair block, the row
    wave in plain torch on the blocks' device."""
    B, Lr = qs.shape[0], rs.shape[1]
    rows = [torch.zeros((B, Lr + 1), dtype=torch.int32, device=qs.device)]
    rows.extend(rowwave_rows(qs, rs))
    H = torch.stack(rows, dim=1)
    return H.amax(dim=(1, 2)), H


def sw_wave_pid(qs, rs, *, chunk: int = 32):
    """Batched scores + PID: the DP matrices of each chunk of pairs on the
    blocks' device, then the host traceback per pair.

    qs (N, Lq) x rs (N, Lr) int8 (tensors or arrays), PAD-padded (padding
    only ever suffixes a sequence, so the argmax cell of each padded DP
    matrix is the unpadded one's). Returns (pid (N,) float64, length (N,)
    int64, score (N,) int64); all-PAD rows give 0, 0, 0.
    """
    qs = torch.as_tensor(qs, dtype=torch.int8)
    rs = torch.as_tensor(rs, dtype=torch.int8)
    N = qs.shape[0]
    pid = np.zeros(N)
    length = np.zeros(N, np.int64)
    score = np.zeros(N, np.int64)
    for i in range(0, N, chunk):
        qc, rc = qs[i:i + chunk], rs[i:i + chunk]
        sc, H = _sw_batch_with_matrix(qc, rc)
        Hn = H.cpu().numpy()
        sc = sc.cpu().numpy()
        qn = qc.cpu().numpy().astype(np.int64)
        rn = rc.cpu().numpy().astype(np.int64)
        for n in range(len(qn)):
            sub = BLOSUM62_PADDED[qn[n]][:, rn[n]]
            p, l = _traceback_pid(Hn[n], qn[n], rn[n], sub)
            pid[i + n] = p
            length[i + n] = l
            score[i + n] = int(sc[n])
    return pid, length, score


# ------------------------------------------------------------ the pair API
def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pair_block(qs, rs, device=None):
    """(B, Lq) x (B, Lr) residues (arrays or tensors) as contiguous int8
    tensors on ``device`` — the card unless another is named."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(x, dtype=torch.int8, device=dev).contiguous()
                 for x in (qs, rs))


def sw_scores_device(qs, rs, *, device=None) -> torch.Tensor:
    """(B, Lq) x (B, Lr) int8 (PAD-padded) -> (B,) int32 best scores, left
    on the device without a host sync (kernel K7 on the card)."""
    from ..kernels import ops
    return ops.sw_rowwave_scores(*pair_block(qs, rs, device))


def sw_align_batch(qs, rs, *, device=None) -> np.ndarray:
    """Batched best-scores: (N, Lq) x (N, Lr) -> (N,) int32 on the host."""
    return sw_scores_device(qs, rs, device=device).cpu().numpy()


def sw_score(q, r, *, device=None) -> int:
    """Best local alignment score of one encoded pair."""
    return int(sw_align_batch(_host(q)[None], _host(r)[None],
                              device=device)[0])


def percent_identity(q, r, *, device=None) -> tuple[float, int, int]:
    """PID of the best local alignment of one encoded pair.

    Returns (pid_percent, alignment_length, score).
    """
    pid, length, score = sw_wave_pid(
        *pair_block(_host(q)[None], _host(r)[None], device), chunk=1)
    return float(pid[0]), int(length[0]), int(score[0])


def batch_percent_identity(pairs, q_ids, q_lens, r_ids, r_lens, *,
                           device=None) -> np.ndarray:
    """PID for each (qi, ri) row of a pair buffer; invalid rows -> nan.

    Valid rows are gathered into padded blocks and scored as one DP wave per
    chunk (bit-exact with the per-pair path, just batched).
    """
    pairs, q_ids, q_lens, r_ids, r_lens = (
        _host(x) for x in (pairs, q_ids, q_lens, r_ids, r_lens))
    out = np.full(len(pairs), np.nan)
    rows = [(n, int(qi), int(ri)) for n, (qi, ri, *_) in enumerate(pairs)
            if qi >= 0]
    if not rows:
        return out
    Lq = int(max(q_lens[qi] for _, qi, _ in rows))
    Lr = int(max(r_lens[ri] for _, _, ri in rows))
    qm = np.full((len(rows), max(Lq, 1)), PAD, np.int8)
    rm = np.full((len(rows), max(Lr, 1)), PAD, np.int8)
    for n, (_, qi, ri) in enumerate(rows):
        qm[n, :int(q_lens[qi])] = q_ids[qi][:int(q_lens[qi])]
        rm[n, :int(r_lens[ri])] = r_ids[ri][:int(r_lens[ri])]
    pid, _, _ = sw_wave_pid(*pair_block(qm, rm, device))
    for n, (slot, _, _) in enumerate(rows):
        out[slot] = pid[n]
    return out
