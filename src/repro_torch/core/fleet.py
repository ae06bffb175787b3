"""Batched fleet-scale OOM/retry simulation engine (PyTorch).

The vectorized reformulation of :func:`repro_torch.core.wastage.
simulate_execution`: instead of replaying every test execution through a
Python loop, a whole batch of (plan, trace) lanes runs the OOM/retry
protocol on one device:

1. plans are padded to ``(B, K)`` step functions (sentinel starts mark the
   unused slots) and traces to ``(B, T)`` with a validity length,
2. each attempt evaluates every lane at once — the first violating sample
   (the simulated OOM killer), the successful-attempt wastage and the
   killed-attempt wastage come from one probe: the hand-written CUDA
   ``oom_probe`` kernel when the batch lives on CUDA, the float32 PyTorch
   formulation below when it lives on the CPU,
3. failed lanes advance through a vectorized retry transform — the KS+
   §II-C re-timing rule and every baseline rule as tensor plan rewrites,
4. a Python loop over attempts runs until every lane has succeeded or is
   unsatisfiable on the node class (``machine_memory``), capped at
   ``max_attempts``; it pays one ``active.any()`` host read per attempt.

All device arithmetic is float32, on the time grid
``float32(i) * float32(dt)``, as in the JAX reference engine, so the
PyTorch path reproduces its violation indices bit for bit.
:func:`simulate_execution` stays the per-execution oracle.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch

from repro_torch.core import envelope as _env
from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.envelope import PackedEnvelopes, RetrySpec
from repro_torch.device import resolve_device

__all__ = [
    "RetrySpec",
    "PackedTraces",
    "TraceBucket",
    "FleetBatch",
    "FleetResult",
    "pack_plans",
    "pack_traces",
    "pad_lane_axis",
    "group_lengths",
    "bucket_traces",
    "subset_batch",
    "packed_predict",
    "concat_packed",
    "simulate_fleet",
    "simulate_fleet_many",
]

# Sentinel start for padded plan slots (float32 view of the shared
# envelope-layer sentinel): far beyond any sample time, so the slot's
# interval is empty and the last real segment's peak is held forever.
PAD_START = np.float32(_env.PAD_START)
_F32 = torch.float32
_I32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class PackedTraces:
    """Padded ``(B, T)`` trace batch, shareable across engine calls."""

    mems: np.ndarray      # (B, T) float32
    lengths: np.ndarray   # (B,)  int32


@dataclasses.dataclass(frozen=True)
class TraceBucket:
    """One length bucket of a :class:`FleetBatch` (lanes of similar T).

    Host copies (``mems``/``lengths``) feed failure compaction; the
    device-resident, lane-padded copies (``dmems``/``dlengths``/``dsummem``)
    are uploaded once and shared by every probe over this bucket.
    """

    idx: np.ndarray       # (b,) lane indices into the original batch
    mems: np.ndarray      # (b, T_bucket) float32, host
    lengths: np.ndarray   # (b,) int32, host
    dmems: torch.Tensor     # (Bp, T_bucket) float32, lane axis padded to pow2
    dmemsneg: torch.Tensor  # (Bp, T_bucket) float32, -inf outside the span
    dlengths: torch.Tensor  # (Bp,) int32
    dsummem: torch.Tensor   # (Bp,) float32: sum of valid samples per lane


@dataclasses.dataclass(frozen=True)
class FleetBatch:
    """Traces grouped into power-of-two length buckets on one device.

    Padding every trace to the global maximum length wastes most of the
    engine's (memory-bound) work on zeros — short tasks dominate real
    workflows while a few long ones set T.  Bucketing keeps the padded
    element count within ~2× of the real sample count.  Build once with
    :func:`bucket_traces` and share across methods / plan batches.
    """

    n: int
    buckets: tuple  # tuple[TraceBucket, ...]
    device: torch.device


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """Per-lane outcome of a fleet simulation (mirrors ExecutionResult)."""

    wastage_gbs: np.ndarray  # (B,) float64
    attempts: np.ndarray     # (B,) int — evaluated attempts (>= 1)
    succeeded: np.ndarray    # (B,) bool

    @property
    def retries(self) -> np.ndarray:
        return self.attempts - 1

    @property
    def total_gbs(self) -> float:
        return float(self.wastage_gbs.sum())


def pack_plans(plans: Sequence[AllocationPlan], k: int | None = None):
    """Pad plans to a common segment count.

    Padded slots get ``PAD_START`` starts (never active) and replicate the
    last real peak, so the packed plan evaluates identically to the original.
    Returns ``(starts, peaks, nseg)`` of shapes (B, K), (B, K), (B,).
    """
    K = int(k if k is not None else max(p.n for p in plans))
    B = len(plans)
    ns = {p.n for p in plans}
    if ns == {K}:  # uniform-width fast path (the common per-method case)
        starts = np.stack([p.starts for p in plans]).astype(np.float32)
        peaks = np.stack([p.peaks for p in plans]).astype(np.float32)
        return starts, peaks, np.full((B,), K, np.int32)
    env = PackedEnvelopes.from_plans(plans, K)
    return (env.starts.astype(np.float32), env.peaks.astype(np.float32),
            env.nseg.astype(np.int32))


def packed_predict(method, inputs: Sequence[float], k: int | None = None):
    """Predict plans for a batch of inputs directly in packed form.

    Uses the method's vectorized ``predict_packed`` when it exposes one
    (every built-in method does), falling back to per-plan ``predict`` +
    :func:`pack_plans`.
    """
    fn = getattr(method, "predict_packed", None)
    if fn is None:
        return pack_plans([method.predict(i) for i in inputs], k)
    starts, peaks = fn(np.asarray(inputs, np.float64))
    starts = np.ascontiguousarray(starts, np.float32)
    peaks = np.ascontiguousarray(peaks, np.float32)
    B, K = starts.shape
    nseg = np.full((B,), K, np.int32)
    if k is not None and k > K:
        starts = np.concatenate(
            [starts, np.full((B, k - K), PAD_START, np.float32)], axis=1)
        peaks = np.concatenate(
            [peaks, np.repeat(peaks[:, -1:], k - K, axis=1)], axis=1)
    return starts, peaks, nseg


def concat_packed(parts: Sequence) -> tuple:
    """Concatenate packed plan triples along lanes, padding K to the max."""
    K = max(p[0].shape[1] for p in parts)
    outs, outp, outn = [], [], []
    for starts, peaks, nseg in parts:
        pad = K - starts.shape[1]
        if pad:
            B = starts.shape[0]
            starts = np.concatenate(
                [starts, np.full((B, pad), PAD_START, np.float32)], axis=1)
            peaks = np.concatenate(
                [peaks, np.repeat(peaks[:, -1:], pad, axis=1)], axis=1)
        outs.append(starts)
        outp.append(peaks)
        outn.append(nseg)
    return (np.concatenate(outs), np.concatenate(outp), np.concatenate(outn))


def pack_traces(mems: Sequence[np.ndarray], min_t: int = 128) -> PackedTraces:
    """Pad traces to a power-of-two length."""
    T = max(max(len(m) for m in mems), min_t)
    T = 1 << (T - 1).bit_length()
    B = len(mems)
    padded = np.zeros((B, T), np.float32)
    lengths = np.zeros((B,), np.int32)
    for i, m in enumerate(mems):
        padded[i, : len(m)] = m
        lengths[i] = len(m)
    return PackedTraces(mems=padded, lengths=lengths)


def _device_bucket(idx, mems, lengths, pmems, plen, summem, device):
    """Upload one lane-padded bucket; ``memsneg`` is -inf past each length."""
    memsneg = np.where(
        np.arange(pmems.shape[1])[None, :] < plen[:, None], pmems, -np.inf
    ).astype(np.float32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return TraceBucket(
        idx=idx, mems=mems, lengths=lengths, dmems=up(pmems),
        dmemsneg=up(memsneg), dlengths=up(plen), dsummem=up(summem))


def _make_bucket(idx: np.ndarray, mems_list, T: int,
                 device: torch.device) -> TraceBucket:
    packed = pack_traces(mems_list, min_t=T)
    b = len(idx)
    Bp = _bucket(b)
    pmems = packed.mems
    plen = packed.lengths
    if Bp != b:
        pmems = np.concatenate(
            [pmems, np.zeros((Bp - b, pmems.shape[1]), np.float32)])
        plen = np.concatenate([plen, np.zeros((Bp - b,), np.int32)])
    summem = np.asarray(
        [m.sum(dtype=np.float64) for m in mems_list]
        + [0.0] * (Bp - b), np.float32)
    return _device_bucket(idx, packed.mems, packed.lengths, pmems, plen,
                          summem, device)


def group_lengths(lengths: Sequence[int], min_t: int = 128,
                  min_lanes: int = 16, max_buckets: int = 4):
    """The bucket policy itself: lane indices grouped by power-of-two
    padded length.  Sparse buckets are merged into the next-longer one
    (below ``min_lanes`` lanes a bucket costs more in per-group overhead
    than its padding saves) and ``max_buckets`` bounds the orchestration
    fan-out.  Returns ``[(T, sorted index array), ...]`` ascending in T.
    """
    by_t: dict = {}
    for i, n in enumerate(lengths):
        T = max(int(n), min_t)
        T = 1 << (T - 1).bit_length()
        by_t.setdefault(T, []).append(i)
    groups = []  # ascending T, merged
    carry: list = []
    for T in sorted(by_t):
        cur = carry + by_t[T]
        if len(cur) < min_lanes and T != max(by_t):
            carry = cur
            continue
        groups.append((T, cur))
        carry = []
    # (the largest-T iteration always appends, so nothing is left in carry)
    while len(groups) > max_buckets:
        # merge the smallest group into the next-longer one
        i = min(range(len(groups) - 1), key=lambda g: len(groups[g][1]))
        T = groups[i + 1][0]
        groups[i + 1] = (T, groups[i][1] + groups[i + 1][1])
        del groups[i]
    return [(T, np.asarray(sorted(ids), np.int64)) for T, ids in groups]


def bucket_traces(mems: Sequence[np.ndarray], min_t: int = 128,
                  min_lanes: int = 16, max_buckets: int = 4, *,
                  device=None) -> FleetBatch:
    """Group traces into power-of-two length buckets on ``device`` (None
    means the card; see FleetBatch and :func:`group_lengths`)."""
    dev = resolve_device(device)
    buckets = []
    for T, idx in group_lengths([len(m) for m in mems], min_t,
                                min_lanes, max_buckets):
        buckets.append(_make_bucket(idx, [mems[i] for i in idx], T, dev))
    return FleetBatch(n=len(mems), buckets=tuple(buckets), device=dev)


def subset_batch(batch: FleetBatch, lanes) -> FleetBatch:
    """Restrict a :class:`FleetBatch` to a lane subset, keeping bucket widths.

    Every selected lane stays in (a copy of) its original bucket with the
    original padded length ``T``, so all per-lane engine arithmetic is
    bit-identical to a run over the full batch — the online replay's
    ``refit="never"`` rounds reproduce the offline replay bitwise through
    this.  ``n`` and the buckets' ``idx`` keep the *original* lane
    numbering, so full-batch plan/result arrays index unchanged.
    """
    want = {int(i) for i in np.asarray(lanes).ravel()}
    buckets = []
    for b in batch.buckets:
        local = np.asarray(
            [p for p, i in enumerate(b.idx) if int(i) in want], np.int64)
        if local.size == 0:
            continue
        nb, T = int(local.size), b.mems.shape[1]
        Bp = _bucket(nb)
        pmems = np.zeros((Bp, T), np.float32)
        pmems[:nb] = b.mems[local]
        plen = np.zeros((Bp,), np.int32)
        plen[:nb] = b.lengths[local]
        # Slice (never recompute) the per-lane trace sums: the originals
        # were reduced from the raw float64 traces, which the float32 host
        # rows kept here cannot reproduce bit-for-bit.
        summem = np.zeros((Bp,), np.float32)
        summem[:nb] = b.dsummem.cpu().numpy()[local]
        buckets.append(_device_bucket(
            b.idx[local], b.mems[local], b.lengths[local], pmems, plen,
            summem, batch.device))
    return FleetBatch(n=batch.n, buckets=tuple(buckets), device=batch.device)


# --------------------------------------------------------------------- probe
def _alloc_on_grid(starts, peaks, T: int, dt: float):
    """``alloc(t) = peaks[#{i : starts_i <= t} - 1]`` on the float32 grid.

    Reproduces the oracle's ``searchsorted(side='right') - 1`` lookup,
    duplicate starts and sentinel padding included; counted slot by slot so
    the work stays (B, T), not (B, T, K).
    """
    B, K = starts.shape
    t = (torch.arange(T, dtype=_F32, device=starts.device) * dt)[None, :]
    cnt = torch.zeros((B, T), dtype=torch.int64, device=starts.device)
    for k in range(K):
        cnt += starts[:, k:k + 1] <= t
    return torch.gather(peaks, 1, (cnt - 1).clamp_(0, K - 1))


def _first_violation(starts, peaks, memsneg, dt: float):
    """First sample with ``mem > alloc`` per lane, or -1 (int32).

    ``memsneg`` is -inf outside the valid span, folding the validity mask
    into the comparison itself.
    """
    B, T = memsneg.shape
    bad = memsneg > _alloc_on_grid(starts, peaks, T, dt)
    i = torch.arange(T, device=memsneg.device)[None, :]
    first = torch.where(bad, i, T).amin(dim=1)
    return torch.where(first < T, first, -1).to(torch.int32)


def _seg_bounds(starts, dt: float):
    """b_k = first sample index i with ``i*dt >= starts_k`` — exactly.

    ``ceil(start/dt)`` alone can be off by one ulp, so both neighbours are
    checked with the *same* float32 arithmetic the probe's time grid uses
    (``float32(i) * dt``), making the boundaries bit-consistent with the
    per-sample comparisons.
    """
    c = torch.clamp(torch.ceil(starts / dt), 0.0, 1.0e9)
    c = c - ((c - 1.0) * dt >= starts).to(_F32)
    c = c + (torch.clamp(c, 0.0, 1.0e9) * dt < starts).to(_F32)
    b = torch.clamp(c, 0.0, 2.0e9).to(torch.int32)
    # segment 0 is active from t=0 regardless (index clipping semantics)
    b[:, 0] = 0
    return b


def _span_alloc_sum(peaks, bounds, upto):
    """``sum_k peaks_k * |[b_k, b_{k+1}) ∩ [0, upto)|`` — the allocation
    integral over the first ``upto`` samples in O(K) per lane.

    Summed slot by slot in order, so padded slots (span 0) leave the sum
    bit-identical whatever K a batch was padded to.
    """
    B, K = peaks.shape
    hi = torch.cat([bounds[:, 1:],
                    torch.full((B, 1), _I32_MAX, dtype=torch.int32,
                               device=bounds.device)], dim=1)
    lo = torch.minimum(bounds, upto[:, None])
    hi = torch.minimum(hi, upto[:, None])
    span = (hi - lo).clamp_(min=0).to(_F32)
    acc = peaks[:, 0] * span[:, 0]
    for k in range(1, K):
        acc = acc + peaks[:, k] * span[:, k]
    return acc


def _probe_first(starts, peaks, memsneg, lengths, summem, dt: float):
    """Attempt-#1 probe: ``(viol, w_succ)`` with w_succ valid where viol<0.

    For a successful attempt ``max(alloc, mem) == alloc`` everywhere, so the
    wastage integral collapses to segment-span arithmetic minus ``summem``.
    """
    viol = _first_violation(starts, peaks, memsneg, dt)
    bounds = _seg_bounds(starts, dt)
    w_succ = (_span_alloc_sum(peaks, bounds, lengths) - summem) * dt
    return viol, w_succ, bounds


def _oom_probe_torch(starts, peaks, mems, memsneg, lengths, summem,
                     dt: float):
    """Full per-attempt probe: ``(viol, w_succ, w_kill, used)``.

    ``w_succ`` is exact only for lanes with ``viol < 0`` (the engine never
    reads it otherwise); ``w_kill`` integrates the allocation up to and
    including the kill sample, again in O(K) spans.
    """
    viol, w_succ, bounds = _probe_first(starts, peaks, memsneg, lengths,
                                        summem, dt)
    v = viol.clamp(min=0)
    w_kill = torch.where(
        viol >= 0, _span_alloc_sum(peaks, bounds, v + 1), 0.0) * dt
    used = torch.gather(mems, 1, v[:, None].long())[:, 0]
    return viol, w_succ, w_kill, used


def _kernel_probe(starts, peaks, mems, lengths, dt: float):
    from repro_torch.kernels.wastage.ops import oom_probe
    return oom_probe(starts.contiguous(), peaks.contiguous(), mems, lengths,
                     dt=dt)


# --------------------------------------------------------------- retry rules
def _retry_transform(spec: RetrySpec, starts, peaks, nseg, t_fail, used,
                     mm, bump=None):
    """Vectorized ``(plan, t_fail, used) -> plan`` over every lane at once.

    Mirrors :mod:`repro_torch.core.retry` rule for rule; lanes that are not
    retrying are masked out by the caller.  ``mm`` is the float32 machine
    memory (0-d tensor); ``bump`` optionally overrides the static
    ``spec.bump`` per lane (a ``(B,)`` tensor).
    """
    B, K = starts.shape
    idx = torch.arange(K, device=starts.device)[None, :]
    real = idx < nseg[:, None]

    if spec.kind == "none":
        return starts, peaks
    if spec.kind == "double":
        return starts, torch.minimum(peaks * 2.0, mm)
    if spec.kind == "max-machine":
        return starts, mm.expand(B, K).clone()

    # Failed segment: last real slot with start <= t_fail (searchsorted-right
    # semantics; sentinel-padded slots never count).
    j = ((starts <= t_fail[:, None]) & real).sum(dim=1) - 1
    j = torch.minimum(j.clamp(min=0), nseg.long() - 1)
    peak_j = torch.gather(peaks, 1, j[:, None])[:, 0]

    if spec.kind == "kseg-selective":
        target = torch.maximum(peak_j * (1.0 + spec.margin),
                               used * (1.0 + spec.margin))
        return starts, torch.where(idx == j[:, None], target[:, None], peaks)

    if spec.kind == "kseg-partial":
        target = torch.maximum(peak_j * (1.0 + spec.margin),
                               used * (1.0 + spec.margin))
        raise_mask = real & (idx >= j[:, None])
        return starts, torch.where(
            raise_mask, torch.maximum(peaks, target[:, None]), peaks)

    if spec.kind == "ksplus":
        is_last = j >= nseg - 1
        # --- re-time branch: next segment begins exactly at the failure time,
        # every later one is scaled by the same factor.
        nxt = torch.gather(starts, 1, torch.clamp(j + 1, max=K - 1)[:, None])
        nxt = nxt[:, 0]
        tiny = torch.tensor(1e-30, dtype=_F32, device=starts.device)
        factor = torch.where(nxt > 0, t_fail / torch.maximum(nxt, tiny), 0.0)
        st = torch.where(real & (idx > (j + 1)[:, None]),
                         starts * factor[:, None], starts)
        st = torch.where(idx == (j + 1)[:, None], t_fail[:, None], st)
        st = torch.cummax(st.clamp(min=0.0), dim=1).values
        st[:, 0] = 0.0
        st = torch.where(real, st, float(PAD_START))
        # --- last-segment branch: bump the final peak, keep monotone.
        bump_col = spec.bump if bump is None else bump[:, None]
        pk = torch.where(idx == (nseg - 1)[:, None],
                         peaks * (1.0 + bump_col), peaks)
        pk = torch.cummax(pk, dim=1).values
        new_starts = torch.where(is_last[:, None], starts, st)
        new_peaks = torch.where(is_last[:, None], pk, peaks)
        return new_starts, new_peaks

    raise ValueError(f"unknown retry kind: {spec.kind!r}")


# -------------------------------------------------------------------- engine
def _engine_loop(starts, peaks, nseg, mems, lengths, mm, *,
                 retry: RetrySpec, dt: float, max_attempts: int,
                 bump_lanes=None):
    """The retry engine over device tensors: ``(wastage, attempts, succ)``.

    A Python loop over attempts (one ``active.any()`` host read each),
    probing with the kernel when ``mems`` lives on CUDA; ``bump_lanes`` is
    an optional ``(B,)`` per-lane override of the ksplus ``retry.bump``.
    """
    B, T = mems.shape
    validb = torch.arange(T, device=mems.device)[None, :] < lengths[:, None]
    # Loop-invariant trace precomputes, amortized over every attempt.
    memsneg = torch.where(validb, mems, -torch.inf)
    summem = torch.where(validb, mems, 0.0).sum(dim=1)
    unsat = memsneg.amax(dim=1) > mm  # no allocation can satisfy

    if mems.device.type == "cuda":
        def probe(s, p):
            viol, w_succ, w_kill = _kernel_probe(s, p, mems, lengths, dt)
            used = torch.gather(
                mems, 1, viol.clamp(min=0)[:, None].long())[:, 0]
            return viol, w_succ, w_kill, used
    else:
        def probe(s, p):
            return _oom_probe_torch(s, p, mems, memsneg, lengths, summem, dt)

    sts, pks = starts, peaks
    active = torch.ones((B,), dtype=torch.bool, device=mems.device)
    succ = torch.zeros((B,), dtype=torch.bool, device=mems.device)
    att = torch.zeros((B,), dtype=torch.int32, device=mems.device)
    w = torch.zeros((B,), dtype=_F32, device=mems.device)
    for _ in range(max_attempts):
        if not bool(active.any()):
            break
        capped = torch.minimum(pks, mm)
        viol, w_succ, w_kill, used = probe(sts, capped)
        failed = viol >= 0
        succ_now = active & ~failed
        w = w + torch.where(succ_now, w_succ, 0.0) \
              + torch.where(active & failed, w_kill, 0.0)
        att = att + active.to(torch.int32)
        succ = succ | succ_now
        retrying = active & failed & ~unsat
        t_fail = viol.clamp(min=0).to(_F32) * dt
        nsts, npks = _retry_transform(
            retry, sts, capped, nseg, t_fail, used, mm, bump=bump_lanes)
        sts = torch.where(retrying[:, None], nsts, sts)
        pks = torch.where(retrying[:, None], npks, capped)
        active = retrying
    return w, att, succ


def _probe_many(groups, mm, *, dt: float):
    """Attempt #1 for many (plan batch, trace bucket) groups.

    ``groups`` is a sequence of ``(starts, peaks, bucket)``; returns the
    per-group ``(viol, w_succ)`` device tensors (the kernel's on CUDA).
    """
    out = []
    for starts, peaks, bucket in groups:
        capped = torch.minimum(peaks, mm)
        if bucket.dmems.device.type == "cuda":
            viol, w_succ, _ = _kernel_probe(
                starts, capped, bucket.dmems, bucket.dlengths, dt)
        else:
            viol, w_succ, _ = _probe_first(
                starts, capped, bucket.dmemsneg, bucket.dlengths,
                bucket.dsummem, dt)
        out.append((viol, w_succ))
    return out


def _retry_many(groups, mm, *, specs, dt: float, max_attempts: int):
    """Full retry loops for many compacted failure groups.

    ``groups`` is a sequence of ``(starts, peaks, nseg, mems, lengths,
    bump)`` device tensors (``bump`` a per-lane ksplus bump or ``None``);
    ``specs`` the matching :class:`RetrySpec` per group.
    """
    return [
        _engine_loop(starts, peaks, nseg, mems, lengths, mm, retry=spec,
                     dt=dt, max_attempts=max_attempts, bump_lanes=bump)
        for spec, (starts, peaks, nseg, mems, lengths, bump)
        in zip(specs, groups)]


def _bucket(b: int, lo: int = 8) -> int:
    return max(lo, 1 << (b - 1).bit_length())


def pad_lane_axis(arrs: Sequence[np.ndarray], fills: Sequence,
                  lo: int = 8, fine: bool = False, sub: int = 8) -> tuple:
    """Pad every array's leading (lane) axis to a shared bucket size.

    Gather the active minority into compact rows, then pad the lane axis
    to a bucketed size.  ``fine=False`` pads to the next power of two;
    ``fine=True`` pads to the next multiple of 1/``sub`` of the next power
    of two (``sub`` shapes per octave, <= 25% padding at the default 8).
    ``fills[i]`` is the pad value for ``arrs[i]``; dtypes are preserved.
    """
    B = int(arrs[0].shape[0])
    Bp = _bucket(B, lo)
    if fine and Bp > lo:
        step = max(Bp // sub, lo)
        Bp = ((B + step - 1) // step) * step
    if Bp == B:
        return tuple(arrs)
    return tuple(
        np.concatenate(
            [a, np.full((Bp - B,) + a.shape[1:], fill, a.dtype)])
        for a, fill in zip(arrs, fills))


def _pad_lanes(starts, peaks, nseg, mems, lengths):
    """Pad the lane axis to a power of two (dummy lanes trivially succeed)."""
    return pad_lane_axis(
        (starts, peaks, nseg, mems, lengths),
        (PAD_START, 1.0, 1, 0.0, 0))


def _as_batch(mems, device) -> FleetBatch:
    """A :class:`FleetBatch` on the requested device.

    A FleetBatch already lives on the device it was built for; asking for
    another one is an error, never a silent copy.
    """
    if isinstance(mems, FleetBatch):
        if device is not None:
            want = resolve_device(device)
            have = mems.device
            if want.type != have.type or (
                    want.index is not None and want.index != have.index):
                raise ValueError(
                    f"FleetBatch lives on {have}, device={want} requested")
        return mems
    dev = resolve_device(device)
    if isinstance(mems, PackedTraces):
        B, T = mems.mems.shape
        rows = [mems.mems[i, : mems.lengths[i]] for i in range(B)]
        return FleetBatch(n=B, buckets=(_make_bucket(np.arange(B), rows, T,
                                                     dev),), device=dev)
    return bucket_traces(mems, device=dev)


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def simulate_fleet_many(
    jobs: Sequence,
    mems: Union[FleetBatch, PackedTraces, Sequence[np.ndarray]],
    dt: float = 1.0,
    *,
    machine_memory: float = np.inf,
    max_attempts: int = 25,
    k: int | None = None,
    device=None,
) -> List[FleetResult]:
    """Run many plan batches against one shared trace batch.

    ``jobs`` is a sequence of ``(plans, retry_spec)`` pairs — e.g. one per
    prediction method — all evaluated against the same executions.  Each
    job's ``plans`` may be a list of :class:`AllocationPlan` or an already
    packed ``(starts, peaks, nseg)`` triple; an optional third element is a
    per-lane ``(B,)`` ksplus last-peak-bump array overriding
    ``retry_spec.bump`` lane for lane (NaN entries keep the spec's value).

    * traces are grouped into power-of-two **length buckets** on ``device``
      (None means the card; a :class:`FleetBatch` keeps its own device),
    * one pass probes attempt #1 of every job × bucket — the usually-large
      majority of lanes that succeeds immediately is settled there, with
      one host read for all groups,
    * the failing minority is **compacted** and the full retry loop runs
      per job × bucket group (re-evaluating their first attempt: a small
      price, on a small subset, for a state-free handoff).

    A batch on CUDA probes with the hand-written ``oom_probe`` kernel, a
    batch on the CPU with the PyTorch formulation.
    """
    batch = _as_batch(mems, device)
    dev = batch.device
    B = batch.n
    norm = []
    for item in jobs:
        plans, r = item[0], item[1]
        spec = RetrySpec(r) if isinstance(r, str) else r
        bump = item[2] if len(item) > 2 else None
        if bump is not None:
            bump = np.where(np.isnan(np.asarray(bump, np.float64)),
                            spec.bump, bump).astype(np.float32)
        norm.append((plans, spec, bump))
    jobs = norm
    packed_jobs = []  # (starts, peaks, nseg) over ALL lanes, per job
    for plans, _, _ in jobs:
        sp = plans if isinstance(plans, tuple) else pack_plans(plans, k)
        if sp[0].shape[0] != B:
            raise ValueError(f"{sp[0].shape[0]} plans vs {B} traces")
        packed_jobs.append(sp)
    mm = torch.tensor(machine_memory, dtype=_F32, device=dev)

    # Phase A: slice each job's packed plans per bucket, probe everything
    # against the buckets' device-resident traces.
    groups = []
    for starts, peaks, nseg in packed_jobs:
        for bucket in batch.buckets:
            bs, bp = starts[bucket.idx], peaks[bucket.idx]
            Bp = bucket.dmems.shape[0]
            if Bp != bs.shape[0]:
                pad = Bp - bs.shape[0]
                bs = np.concatenate(
                    [bs, np.full((pad, bs.shape[1]), PAD_START, np.float32)])
                bp = np.concatenate(
                    [bp, np.ones((pad, bp.shape[1]), np.float32)])
            groups.append((_to_dev(bs.astype(np.float32), dev),
                           _to_dev(bp.astype(np.float32), dev), bucket))
    probes = _probe_many(groups, mm, dt=float(dt))
    # One host read for every group's outcome.
    viols = torch.cat([v for v, _ in probes]).cpu().numpy()
    wsuccs = torch.cat([w for _, w in probes]).cpu().numpy()

    results = [
        FleetResult(wastage_gbs=np.zeros((B,), np.float64),
                    attempts=np.ones((B,), np.int64),
                    succeeded=np.zeros((B,), bool))
        for _ in jobs
    ]

    # Phase B: compact failures per group, run every retry loop.
    fail_groups, fail_specs, fail_meta = [], [], []
    off = 0
    for j, (_, spec, bump) in enumerate(jobs):
        starts, peaks, nseg = packed_jobs[j]
        for bucket in batch.buckets:
            b = len(bucket.idx)
            Bp = bucket.dmems.shape[0]
            viol = viols[off:off + b]
            w_succ = wsuccs[off:off + b].astype(np.float64)
            off += Bp
            ok = viol < 0
            res = results[j]
            res.wastage_gbs[bucket.idx[ok]] = w_succ[ok]
            res.succeeded[bucket.idx[ok]] = True
            if not ok.all():
                local = np.nonzero(~ok)[0]
                fail = bucket.idx[local]
                padded = _pad_lanes(
                    starts[fail].astype(np.float32),
                    peaks[fail].astype(np.float32),
                    nseg[fail].astype(np.int32),
                    bucket.mems[local], bucket.lengths[local])
                fbump = None
                if bump is not None:
                    (fbump,) = pad_lane_axis(
                        (bump[fail],), (np.float32(spec.bump),))
                    fbump = _to_dev(fbump, dev)
                fail_groups.append(
                    tuple(_to_dev(a, dev) for a in padded) + (fbump,))
                fail_specs.append(spec)
                fail_meta.append((j, fail, len(fail)))

    if fail_groups:
        outs = _retry_many(
            fail_groups, mm, specs=fail_specs, dt=float(dt),
            max_attempts=max_attempts)
        # One host read for every retry group's outcome.
        ws = torch.cat([o[0] for o in outs]).cpu().numpy()
        atts = torch.cat([o[1] for o in outs]).cpu().numpy()
        sucs = torch.cat([o[2] for o in outs]).cpu().numpy()
        off = 0
        for (j, out_idx, nf), out in zip(fail_meta, outs):
            res = results[j]
            res.wastage_gbs[out_idx] = ws[off:off + nf].astype(np.float64)
            res.attempts[out_idx] = atts[off:off + nf]
            res.succeeded[out_idx] = sucs[off:off + nf]
            off += out[0].shape[0]
    return results


def simulate_fleet(
    plans: Sequence[AllocationPlan],
    retry: Union[RetrySpec, str],
    mems: Union[FleetBatch, PackedTraces, Sequence[np.ndarray]],
    dt: float = 1.0,
    *,
    machine_memory: float = np.inf,
    max_attempts: int = 25,
    k: int | None = None,
    bump_lanes: np.ndarray | None = None,
    device=None,
) -> FleetResult:
    """Simulate one execution per (plan, trace) lane — the fleet primitive.

    Drop-in batched equivalent of calling
    :func:`repro_torch.core.wastage.simulate_execution` per lane; see
    :func:`simulate_fleet_many` for the orchestration (this is the
    single-job case).  ``bump_lanes`` optionally assigns a per-lane ksplus
    last-peak bump (NaN = keep ``retry``'s static value).
    """
    return simulate_fleet_many(
        [(plans, retry, bump_lanes)], mems, dt,
        machine_memory=machine_memory, max_attempts=max_attempts,
        k=k, device=device)[0]
