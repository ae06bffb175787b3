"""KS+ dynamic segmentation (Algorithm 1 of the paper).

A memory trace ``M[0..L)`` is compressed into at most ``k`` variable-length
segments ``(S_i, P_i)`` (duration in samples, peak memory) forming a
monotonically non-decreasing step function that upper-bounds the trace.

Two phases:

1. *Monotone compression*: a new segment starts exactly at each strict
   running-maximum record of the trace; every other sample extends the
   current segment.  This yields strictly increasing peaks and guarantees
   ``M[t] <= P_seg(t)`` for every sample.  (The printed pseudocode's
   branches are swapped relative to the paper's prose; the prose semantics
   are implemented, as in the reference package.)

2. *Greedy merging*: while more than ``k`` segments remain, merge the
   segment ``i`` with the smallest merge error
   ``e_i = (P_{i+1} - P_i) * S_i`` into its successor (the merged segment
   keeps the successor's larger peak).  Ties take the first minimum.

Two implementations are provided:

* :func:`get_segments_ref` — plain-numpy oracle, variable-length output.
* :func:`get_segments` — fixed-shape PyTorch version batched over a
  ``(N, T)`` trace batch: phase 1 is a ``cummax`` plus a scatter-max of the
  record peaks, phase 2 a masked loop of merge steps over every lane at
  once that stops when every lane has ``n <= k``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["get_segments_ref", "get_segments", "segments_to_starts"]


# ---------------------------------------------------------------------------
# numpy reference (oracle)
# ---------------------------------------------------------------------------


def get_segments_ref(M: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reference implementation of Algorithm 1.

    Args:
      M: 1-D array of memory samples (length >= 1).
      k: maximum number of output segments (>= 1).

    Returns:
      ``(S, P)`` — integer durations (samples) and float peaks, with
      ``len(S) == len(P) <= k``, ``sum(S) == len(M)``, ``P`` strictly
      increasing, and ``P_seg(t) >= M[t]`` for all ``t``.
    """
    M = np.asarray(M, dtype=np.float64)
    if M.ndim != 1 or M.size == 0:
        raise ValueError("M must be a non-empty 1-D array")
    if k < 1:
        raise ValueError("k must be >= 1")

    # Phase 1: monotone compression — new segment at each strict record.
    S = [1]
    P = [float(M[0])]
    for m in M[1:]:
        if m > P[-1]:
            P.append(float(m))
            S.append(1)
        else:
            S[-1] += 1

    # Phase 2: greedy merging down to k segments.
    while len(P) > k:
        e = [(P[i + 1] - P[i]) * S[i] for i in range(len(P) - 1)]
        idx = int(np.argmin(e))  # first minimum on ties, as in the paper
        S[idx + 1] += S[idx]
        del S[idx]
        del P[idx]

    return np.asarray(S, dtype=np.int64), np.asarray(P, dtype=np.float64)


# ---------------------------------------------------------------------------
# PyTorch fixed-shape batched implementation
# ---------------------------------------------------------------------------


def _phase1_monotone(M: torch.Tensor, valid: torch.Tensor):
    """Vectorized monotone compression over a padded ``(N, T)`` batch.

    ``valid`` must be a prefix mask per lane.  Returns ``(P, S, n)``:
    (N, T) peaks / (N, T) int32 durations compacted to the first ``n``
    entries of each lane (rest zero), and the (N,) int32 segment counts.
    """
    N, T = M.shape
    m = torch.where(valid, M, -torch.inf)
    run_max = torch.cummax(m, dim=1).values
    prev_max = torch.cat(
        [torch.full((N, 1), -torch.inf, dtype=M.dtype, device=M.device),
         run_max[:, :-1]], dim=1)
    is_new = (m > prev_max) & valid
    seg_id = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    seg_id = torch.where(valid, seg_id, T - 1)  # padding into a sink slot

    # Peak of each segment = value at its record point (= running max there).
    P = torch.zeros((N, T), dtype=M.dtype, device=M.device).scatter_reduce(
        1, seg_id, m, reduce="amax", include_self=True)
    S = torch.zeros((N, T), dtype=torch.int32, device=M.device).scatter_add(
        1, seg_id, valid.to(torch.int32))
    n = is_new.sum(dim=1, dtype=torch.int32)
    # Clean the sink slot if no real segment landed there.
    slot_valid = torch.arange(T, device=M.device)[None, :] < n[:, None]
    P = torch.where(slot_valid, P, 0.0)
    S = torch.where(slot_valid, S, 0)
    return P, S, n


def _merge_step(P, S, n, active):
    """One greedy merge in every ``active`` lane (others unchanged)."""
    N, W = P.shape
    ar = torch.arange(W, device=P.device)[None, :]
    e = (P[:, 1:] - P[:, :-1]) * S[:, :-1].to(P.dtype)
    e = torch.where(ar[:, :-1] < (n - 1)[:, None], e, torch.inf)
    idx = torch.argmin(e, dim=1, keepdim=True)  # first minimum on ties
    merged = S.scatter_add(1, idx + 1, torch.gather(S, 1, idx))
    # Shift entries left over the removed slot.
    src = torch.where(ar >= idx, ar + 1, ar).clamp_(max=W - 1)
    keep = ar < (n - 1)[:, None]
    P2 = torch.where(keep, torch.gather(P, 1, src), 0.0)
    S2 = torch.where(keep, torch.gather(merged, 1, src), 0)
    act = active[:, None]
    return (torch.where(act, P2, P), torch.where(act, S2, S),
            torch.where(active, n - 1, n))


def get_segments(M: torch.Tensor, lengths: torch.Tensor, k: int):
    """Batched fixed-shape Algorithm 1.

    Args:
      M:       (N, T) padded float traces.
      lengths: (N,) number of valid leading samples per lane.
      k:       maximum segment count.

    Returns:
      ``(S, P, n)``: (N, k) int32 durations, (N, k) float peaks and the
      (N,) int32 segment counts ``n <= k``.  Slots ``>= n`` are zero.
    """
    N, T = M.shape
    valid = torch.arange(T, device=M.device)[None, :] < lengths[:, None]
    P, S, n = _phase1_monotone(M, valid)
    # Merging only ever reads the first n slots of a lane: work on the
    # widest lane's segments instead of all T samples.
    steps = int((n - k).clamp(min=0).max()) if N else 0
    W = max(int(n.max()) if N else 0, k, 1)
    if W > T:
        pad = W - T
        P = torch.cat([P, P.new_zeros((N, pad))], dim=1)
        S = torch.cat([S, S.new_zeros((N, pad))], dim=1)
    P, S = P[:, :W], S[:, :W]
    for _ in range(steps):
        P, S, n = _merge_step(P, S, n, n > k)
    return S[:, :k], P[:, :k], n


def segments_to_starts(S: torch.Tensor, n=None):
    """Durations -> start offsets (samples). Slot i starts at sum(S[:i]).

    Padding slots (>= n) get the total length so they never activate early.
    """
    starts = torch.cumsum(S, dim=-1) - S  # exclusive prefix sum
    if n is not None:
        total = S.sum(dim=-1, keepdim=True)
        slot = torch.arange(S.shape[-1], device=S.device)
        starts = torch.where(slot < torch.as_tensor(n)[..., None], starts,
                             total)
    return starts
