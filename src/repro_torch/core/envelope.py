"""Packed time-varying memory envelopes — the shared representation.

Every layer of this system speaks "allocation envelope": a monotone-indexable
step function ``alloc(t) = peaks[#{i : starts_i <= t} - 1]``.  This module is
the single implementation of that arithmetic, in *packed* ``(B, K)`` form —
``B`` lanes of up to ``K`` segments, unused slots marked by a sentinel start
(:data:`PAD_START`) and a replicated last peak so padded rows evaluate
identically to their originals.

Consumers:

* :mod:`repro_torch.core.allocation` — per-plan scalar helpers, 1-lane views
  of these functions,
* :mod:`repro_torch.core.retry` — per-plan retry rules, 1-lane views of
  :func:`retry_packed`,
* :mod:`repro_torch.core.fleet` — the batched OOM/retry engine (same layout,
  cast to float32 on the way to the device),
* :mod:`repro_torch.core.registry` — offset tuning (:func:`apply_offsets`).

Everything here is plain float64 numpy: it is the bit reference the float32
device paths are differentially tested against.  ``usage_over`` /
``residual_over`` / ``fits_column`` serve the scheduler's admission layer,
which has not been carried over to this package yet.

Times are seconds, memory is GB throughout ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np

__all__ = [
    "PAD_START",
    "RetrySpec",
    "OffsetCandidate",
    "apply_offsets",
    "PackedEnvelopes",
    "alloc_at_packed",
    "first_violation_packed",
    "segment_sample_bounds",
    "span_alloc_sum",
    "usage_over",
    "residual_over",
    "fits_under",
    "fits_column",
    "retry_packed",
]

# Sentinel start for padded plan slots: far beyond any sample time, so the
# slot's interval is empty and the last real segment's peak is held forever.
PAD_START = 1e30


class RetrySpec(NamedTuple):
    """Static description of a method's failure-handling rule.

    kind:
      * ``"ksplus"``         — §II-C re-time, or bump the last peak,
      * ``"kseg-selective"`` — raise only the failed segment's peak,
      * ``"kseg-partial"``   — raise the failed segment and every later one,
      * ``"double"``         — double every peak (capped at machine memory),
      * ``"max-machine"``    — allocate the whole machine,
      * ``"none"``           — keep the plan (retry changes nothing).

    Hashable on purpose: it selects the fleet engine's retry transform and
    is a dict key in the harness's per-method bookkeeping.
    """

    kind: str
    bump: float = 0.20    # ksplus last-segment peak bump
    margin: float = 0.10  # k-segments offset margin


@dataclasses.dataclass(frozen=True)
class OffsetCandidate:
    """One (peak, start, last_peak_bump) safety-offset assignment.

    Applied *on top of* the offsets the plans already carry: segment peaks
    are scaled by ``1 + peak``, starts by ``1 - start`` (then re-pinned and
    made monotone, exactly like the predictor's own offsets), and ksplus
    retries use ``last_peak_bump`` when given.  ``OffsetCandidate()`` is the
    identity — it reproduces the un-swept run decision for decision.

    Every field accepts a per-lane ``(B,)`` array as well as a scalar:
    ``peak``/``start`` flow through :func:`apply_offsets`, and a per-lane
    ``last_peak_bump`` rides the ``bump`` axis of :func:`retry_packed` /
    the fleet engine (NaN entries fall back to the retry spec's static
    bump) — so per-task-family tuning winners may disagree on all three.
    """

    peak: float | np.ndarray = 0.0
    start: float | np.ndarray = 0.0
    last_peak_bump: float | np.ndarray | None = None


def apply_offsets(starts: np.ndarray, peaks: np.ndarray, nseg: np.ndarray,
                  cand: OffsetCandidate):
    """Re-scale a packed plan batch under one offset candidate (O(BK)).

    Elementwise scaling only — the plans' own shape (including the
    non-monotone envelopes k-Segments emits) is preserved, so the identity
    candidate reproduces the input plans exactly.  Per-lane candidates are
    supported by passing ``(B,)``-shaped ``cand.peak`` / ``cand.start``
    arrays.  Returns new ``(starts, peaks)`` float64 arrays.
    """
    starts = np.asarray(starts, np.float64)
    peaks = np.asarray(peaks, np.float64)
    B, K = starts.shape
    real = np.arange(K)[None, :] < np.asarray(nseg).reshape(B, 1)
    p_off = np.asarray(cand.peak, np.float64).reshape(-1, 1)
    s_off = np.asarray(cand.start, np.float64).reshape(-1, 1)
    st = np.where(real, starts * (1.0 - s_off), PAD_START)
    st = np.maximum.accumulate(np.maximum(st, 0.0), axis=1)
    st[:, 0] = 0.0
    st = np.where(real, st, PAD_START)
    pk = np.maximum(peaks * (1.0 + p_off), 1e-6)
    return st, pk


@dataclasses.dataclass(frozen=True)
class PackedEnvelopes:
    """``(B, K)`` batch of step-function envelopes (float64, host-side).

    Attributes:
      starts: (B, K) ascending start offsets; padded slots = ``PAD_START``.
      peaks:  (B, K) allocation per segment; padded slots replicate the last
              real peak (so evaluation never needs the mask).
      nseg:   (B,)  real segment counts.
    """

    starts: np.ndarray
    peaks: np.ndarray
    nseg: np.ndarray

    @property
    def B(self) -> int:
        return int(self.starts.shape[0])

    @property
    def K(self) -> int:
        return int(self.starts.shape[1])

    @classmethod
    def from_plans(cls, plans: Sequence, k: int | None = None
                   ) -> "PackedEnvelopes":
        """Pack plan-like objects (``.starts``/``.peaks`` 1-D arrays).

        Padded slots get ``PAD_START`` starts (never active) and replicate
        the last real peak, so the packed row evaluates identically to the
        original plan.
        """
        K = int(k if k is not None else max(len(p.starts) for p in plans))
        B = len(plans)
        starts = np.full((B, K), PAD_START, np.float64)
        peaks = np.zeros((B, K), np.float64)
        nseg = np.zeros((B,), np.int64)
        for i, p in enumerate(plans):
            n = len(p.starts)
            if n > K:
                raise ValueError(f"plan {i} has {n} segments > K={K}")
            starts[i, :n] = p.starts
            peaks[i, :n] = p.peaks
            peaks[i, n:] = p.peaks[n - 1]
            nseg[i] = n
        return cls(starts=starts, peaks=peaks, nseg=nseg)

    def row(self, i: int):
        """``(starts, peaks)`` of lane ``i`` with padding stripped."""
        n = int(self.nseg[i])
        return self.starts[i, :n].copy(), self.peaks[i, :n].copy()


def alloc_at_packed(starts: np.ndarray, peaks: np.ndarray,
                    t: np.ndarray) -> np.ndarray:
    """Evaluate ``B`` packed step functions at times ``t`` (vectorized).

    ``alloc[b, j] = peaks[b, #{i : starts[b, i] <= t[b, j]} - 1]`` — exactly
    ``searchsorted(side='right') - 1`` per lane, duplicate starts and
    sentinel padding included.

    Args:
      starts/peaks: (B, K).
      t: (T,) shared across lanes, or (B, ...) per-lane times.

    Returns alloc of shape (B, T) (shared grid) or ``t.shape`` (per-lane).
    """
    starts = np.asarray(starts, np.float64)
    peaks = np.asarray(peaks, np.float64)
    t = np.asarray(t, np.float64)
    B, K = starts.shape
    shared = t.ndim == 1
    tt = np.broadcast_to(t, (B,) + t.shape) if shared else t
    flat = tt.reshape(B, -1)
    idx = np.sum(starts[:, None, :] <= flat[:, :, None], axis=2) - 1
    idx = np.clip(idx, 0, K - 1)
    return np.take_along_axis(peaks, idx, axis=1).reshape(tt.shape)


def first_violation_packed(starts: np.ndarray, peaks: np.ndarray,
                           mems: np.ndarray, lengths: np.ndarray,
                           dt: float) -> np.ndarray:
    """First sample per lane with ``mem > alloc + 1e-12``, or -1.

    The float64 OOM-killer oracle (`repro_torch.core.allocation.first_violation`
    is the 1-lane view); the fleet engine's float32 probe is differentially
    tested against this.
    """
    mems = np.asarray(mems, np.float64)
    B, T = mems.shape
    t = np.arange(T, dtype=np.float64) * dt
    alloc = alloc_at_packed(starts, peaks, t)
    valid = np.arange(T)[None, :] < np.asarray(lengths).reshape(B, 1)
    bad = (mems > alloc + 1e-12) & valid
    any_v = bad.any(axis=1)
    vidx = bad.argmax(axis=1)
    return np.where(any_v, vidx, -1).astype(np.int64)


def segment_sample_bounds(starts: np.ndarray, dt) -> np.ndarray:
    """``b_k`` = first sample index ``i`` with ``i*dt >= starts_k`` — exact.

    ``ceil(start/dt)`` alone can be off by one ulp, so both neighbours are
    checked with the *same* float64 arithmetic the sample grid uses, making
    the spans bit-consistent with per-sample ``starts_k <= i*dt`` tests.
    ``dt`` may be a scalar or a per-lane ``(B, 1)`` array.
    """
    starts = np.asarray(starts, np.float64)
    dt = np.asarray(dt, np.float64)
    c = np.ceil(starts / dt)
    c = c - ((c - 1.0) * dt >= starts)
    c = c + (np.maximum(c, 0.0) * dt < starts)
    b = np.clip(c, 0, 2**62).astype(np.int64)
    # segment 0 is active from t=0 regardless (index clipping semantics)
    b[:, 0] = 0
    return b


def span_alloc_sum(peaks: np.ndarray, bounds: np.ndarray,
                   upto: np.ndarray) -> np.ndarray:
    """``sum_k peaks_k * |[b_k, b_{k+1}) ∩ [0, upto)|`` per lane.

    The allocation integral (in samples — multiply by ``dt`` for GB·s) over
    the first ``upto`` samples in O(K) per lane instead of a per-sample pass.
    """
    peaks = np.asarray(peaks, np.float64)
    B, K = peaks.shape
    upto = np.asarray(upto, np.int64).reshape(B, 1)
    hi = np.concatenate([bounds[:, 1:], np.full((B, 1), 2**62, np.int64)],
                        axis=1)
    lo = np.minimum(bounds, upto)
    hi = np.minimum(hi, upto)
    return np.sum(peaks * np.maximum(hi - lo, 0), axis=1)


def usage_over(starts: np.ndarray, peaks: np.ndarray, t0: np.ndarray,
               t: np.ndarray, dur: np.ndarray | None = None) -> np.ndarray:
    """Summed allocation of ``R`` time-shifted envelopes at absolute times.

    Envelope ``r`` is evaluated at ``max(t - t0[r], 0)``; with ``dur`` given
    it only counts inside its active window ``[t0[r], t0[r] + dur[r])`` (the
    cluster's anticipating residual — allocation is freed at the projected
    end), without it the envelope counts forever (the elastic planner's
    conservative headroom).

    Args:
      starts/peaks: (R, K) packed envelopes.
      t0:  (R,) absolute placement times.
      t:   (...,) absolute evaluation times, shared by all envelopes.
      dur: optional (R,) active-window lengths.

    Returns the summed usage, shaped like ``t``.
    """
    t = np.asarray(t, np.float64)
    R = int(np.asarray(starts).shape[0])
    if R == 0:
        return np.zeros(t.shape, np.float64)
    lead = (R,) + (1,) * t.ndim
    rel = t[None, ...] - np.asarray(t0, np.float64).reshape(lead)
    alloc = alloc_at_packed(
        starts, peaks, np.maximum(rel, 0.0).reshape(R, -1)).reshape(rel.shape)
    if dur is not None:
        active = (rel >= 0.0) & (
            rel < np.asarray(dur, np.float64).reshape(lead) + 1e-9)
        alloc = np.where(active, alloc, 0.0)
    return alloc.sum(axis=0)


def residual_over(capacity: float, starts: np.ndarray, peaks: np.ndarray,
                  t0: np.ndarray, t: np.ndarray,
                  dur: np.ndarray | None = None) -> np.ndarray:
    """Node residual envelope: ``capacity - usage_over(...)``."""
    return capacity - usage_over(starts, peaks, t0, t, dur)


def fits_under(need: np.ndarray, resid: np.ndarray,
               tol: float = 1e-9) -> np.ndarray:
    """Vectorized fits-under-residual reduction: ``all(need <= resid + tol)``
    over the trailing (grid) axis — the scheduler's admission predicate for
    every queued job at once."""
    return np.all(np.asarray(need) <= np.asarray(resid) + tol, axis=-1)


def fits_column(capacity: float, run_starts: np.ndarray,
                run_peaks: np.ndarray, run_t0: np.ndarray,
                need: np.ndarray, grid_abs: np.ndarray,
                dur: np.ndarray | None = None, tol: float = 1e-9):
    """One node's admission column: ``(fits, resid)`` for every queued job.

    The float64 reference the fused admission kernel is pinned to:
    ``resid`` is the node's residual envelope under its resident
    (time-shifted, optionally windowed) allocations evaluated on each
    queued job's absolute horizon grid, and ``fits`` the pointwise
    admission predicate.  Shapes: ``run_*`` are the ``R`` resident
    envelopes, ``need``/``grid_abs`` are ``(Q, G)``.
    """
    resid = residual_over(capacity, run_starts, run_peaks, run_t0,
                          grid_abs, dur)
    return fits_under(need, resid, tol), resid


def retry_packed(spec: RetrySpec, starts: np.ndarray, peaks: np.ndarray,
                 nseg: np.ndarray, t_fail: np.ndarray, used: np.ndarray,
                 machine_memory: float = np.inf,
                 bump: np.ndarray | None = None):
    """Vectorized ``(plan, t_fail, used) -> plan`` over every lane at once.

    The float64 reference for every retry rule; the per-plan functions in
    :mod:`repro_torch.core.retry` are 1-lane views of this, and the fleet
    engine's float32 tensor transform mirrors it rule for rule.  Returns ``(starts, peaks)``
    (new arrays; inputs are not modified).

    ``bump`` optionally overrides ``spec.bump`` *per lane* (a ``(B,)``
    array) — the ksplus last-peak bump is the one retry parameter offset
    tuning sweeps, and per-task-family winners may disagree on it within
    one packed batch.  ``None`` keeps the spec's static value everywhere.
    """
    starts = np.asarray(starts, np.float64)
    peaks = np.asarray(peaks, np.float64)
    B, K = starts.shape
    nseg = np.asarray(nseg, np.int64).reshape(B)
    t_fail = np.asarray(t_fail, np.float64).reshape(B)
    used = np.asarray(used, np.float64).reshape(B)
    idx = np.arange(K)[None, :]
    real = idx < nseg[:, None]

    if spec.kind == "none":
        return starts.copy(), peaks.copy()
    if spec.kind == "double":
        return starts.copy(), np.minimum(peaks * 2.0, machine_memory)
    if spec.kind == "max-machine":
        return starts.copy(), np.full_like(peaks, machine_memory)

    # Failed segment: last real slot with start <= t_fail (searchsorted-right
    # semantics; sentinel-padded slots never count).
    j = np.sum((starts <= t_fail[:, None]) & real, axis=1) - 1
    j = np.clip(j, 0, None)
    jcol = j[:, None]
    peak_j = np.take_along_axis(peaks, jcol, axis=1)[:, 0]

    if spec.kind == "kseg-selective":
        target = np.maximum(peak_j * (1.0 + spec.margin),
                            used * (1.0 + spec.margin))
        return starts.copy(), np.where(idx == jcol, target[:, None], peaks)

    if spec.kind == "kseg-partial":
        target = np.maximum(peak_j * (1.0 + spec.margin),
                            used * (1.0 + spec.margin))
        return starts.copy(), np.where(
            idx >= jcol, np.maximum(peaks, target[:, None]), peaks)

    if spec.kind == "ksplus":
        bump_col = (spec.bump if bump is None
                    else np.asarray(bump, np.float64).reshape(B, 1))
        is_last = (j >= nseg - 1)[:, None]
        # --- re-time branch: next segment begins exactly at the failure time,
        # every later one is scaled by the same factor.
        nxt = np.take_along_axis(
            starts, np.minimum(j + 1, K - 1)[:, None], axis=1)[:, 0]
        safe = np.where(nxt > 0, nxt, 1.0)
        factor = np.where(nxt > 0, t_fail / safe, 0.0)
        st = np.where(real & (idx > jcol), starts * factor[:, None], starts)
        st = np.where(real & (idx == jcol + 1), t_fail[:, None], st)
        st = np.maximum.accumulate(np.maximum(st, 0.0), axis=1)
        st[:, 0] = 0.0
        st = np.where(real, st, PAD_START)
        # --- last-segment branch: bump the final peak, keep monotone.
        pk = np.where(idx == (nseg - 1)[:, None],
                      peaks * (1.0 + bump_col), peaks)
        pk = np.maximum.accumulate(pk, axis=1)
        return (np.where(is_last, starts, st), np.where(is_last, pk, peaks))

    raise ValueError(f"unknown retry kind: {spec.kind!r}")
