"""Batched fleet-scale OOM/retry simulation engine (PyTorch).

The vectorized reformulation of :func:`repro_torch.core.wastage.
simulate_execution`: instead of replaying every test execution through a
Python loop, a whole batch of (plan, trace) lanes runs the OOM/retry
protocol on one device:

1. plans are padded to ``(B, K)`` step functions (sentinel starts mark the
   unused slots) and traces are grouped into power-of-two length buckets
   with a validity length per row,
2. every (plan batch, trace bucket) pair becomes one group of a
   :class:`~repro_torch.kernels.wastage.ops.GroupTable`, and
   :func:`~repro_torch.kernels.wastage.ops.fleet_engine` runs the whole
   protocol for every lane of every group: each attempt finds the first
   violating sample (the simulated OOM killer) and the successful- or
   killed-attempt wastage, failed lanes advance through the retry rule
   (the KS+ §II-C re-timing rule or a baseline's), until every lane has
   succeeded, is unsatisfiable on the node class (``machine_memory``) or
   has used ``max_attempts``.

On a CUDA batch that is ONE launch of the hand-written kernel and one host
read per call.  On a CPU batch it is the kernel's plain version
(:func:`repro_torch.kernels.wastage.ref.plain_engine`): attempt 1 of every
lane at once, then a Python loop over attempts for the compacted failures,
as tensor plan rewrites.

All arithmetic is float32, on the time grid ``float32(i) * float32(dt)``,
as in the JAX reference engine, so both reproduce its violation indices and
attempts bit for bit.  :func:`simulate_execution` stays the per-execution
oracle.
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
from repro_torch.kernels.wastage import ops

__all__ = [
    "RetrySpec",
    "PackedTraces",
    "TraceBucket",
    "FleetBatch",
    "FleetResult",
    "pack_plans",
    "pack_traces",
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


@dataclasses.dataclass(frozen=True)
class PackedTraces:
    """Padded ``(B, T)`` trace batch, shareable across engine calls."""

    mems: np.ndarray      # (B, T) float32
    lengths: np.ndarray   # (B,)  int32


@dataclasses.dataclass(frozen=True)
class TraceBucket:
    """One length bucket of a :class:`FleetBatch` (lanes of similar T).

    The device copies (``dmems``/``dlengths``/``dsummem``) are uploaded once
    and shared by every group over this bucket; the host copies
    (``mems``/``lengths``) feed :func:`subset_batch`.
    """

    idx: np.ndarray       # (b,) lane indices into the original batch
    mems: np.ndarray      # (b, T_bucket) float32, host
    lengths: np.ndarray   # (b,) int32, host
    dmems: torch.Tensor     # (b, T_bucket) float32
    dlengths: torch.Tensor  # (b,) int32
    dsummem: torch.Tensor   # (b,) float32: sum of valid samples per lane


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


def _device_bucket(idx, mems, lengths, summem, device):
    """Upload one bucket's rows, lengths and per-row sums."""
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return TraceBucket(idx=idx, mems=mems, lengths=lengths, dmems=up(mems),
                       dlengths=up(lengths), dsummem=up(summem))


def _make_bucket(idx: np.ndarray, mems_list, T: int,
                 device: torch.device) -> TraceBucket:
    packed = pack_traces(mems_list, min_t=T)
    summem = np.asarray([m.sum(dtype=np.float64) for m in mems_list],
                        np.float32)
    return _device_bucket(idx, packed.mems, packed.lengths, summem, device)


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
        # Slice (never recompute) the per-lane trace sums: the originals
        # were reduced from the raw float64 traces, which the float32 host
        # rows kept here cannot reproduce bit-for-bit.
        summem = b.dsummem.cpu().numpy()[local]
        buckets.append(_device_bucket(
            b.idx[local], b.mems[local], b.lengths[local], summem,
            batch.device))
    return FleetBatch(n=batch.n, buckets=tuple(buckets), device=batch.device)


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


def _engine_table(jobs: Sequence, batch: FleetBatch, k: int | None = None):
    """The group table of a :func:`simulate_fleet_many` call: one group per
    job × bucket, the longest bucket's groups first (the kernel's warps take
    lanes in table order).  Returns ``(table, owners)`` with ``owners[g] =
    (job, lane indices into the batch)``."""
    groups, owners = [], []
    packed = []
    for item in jobs:
        plans, r = item[0], item[1]
        spec = RetrySpec(r) if isinstance(r, str) else r
        starts, peaks, nseg = plans if isinstance(plans, tuple) \
            else pack_plans(plans, k)
        if starts.shape[0] != batch.n:
            raise ValueError(f"{starts.shape[0]} plans vs {batch.n} traces")
        starts = np.asarray(starts, np.float32)
        peaks = np.asarray(peaks, np.float32)
        nseg = np.asarray(nseg, np.int32)
        bump = item[2] if len(item) > 2 else None
        if bump is not None:
            bump = np.where(np.isnan(np.asarray(bump, np.float64)),
                            spec.bump, bump).astype(np.float32)
        packed.append((starts, peaks, nseg, bump, spec))
    for bucket in reversed(batch.buckets):
        i = bucket.idx
        for j, (starts, peaks, nseg, bump, spec) in enumerate(packed):
            groups.append(ops.Group(
                starts[i], peaks[i], bucket.dmems, bucket.dlengths,
                nseg=nseg[i], summem=bucket.dsummem,
                bump_lanes=None if bump is None else bump[i],
                kind=spec.kind, margin=spec.margin, bump=spec.bump))
            owners.append((j, i))
    return ops.GroupTable(groups, batch.device), owners


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
    packed ``(starts, peaks, nseg)`` triple, with non-decreasing starts (as
    every method emits them; the engine raises on others); an optional third element is a per-lane
    ``(B,)`` ksplus last-peak-bump array overriding ``retry_spec.bump``
    lane for lane (NaN entries keep the spec's value).

    Traces are grouped into power-of-two **length buckets** on ``device``
    (None means the card; a :class:`FleetBatch` keeps its own device), and
    every job × bucket pair is one group of one
    :func:`~repro_torch.kernels.wastage.ops.fleet_engine` call: on a CUDA
    batch one launch of the hand-written kernel runs every attempt of every
    lane, and the outcome comes back in one host read; on a CPU batch
    the plain engine runs.
    """
    batch = _as_batch(mems, device)
    B = batch.n
    results = [FleetResult(wastage_gbs=np.zeros((B,), np.float64),
                           attempts=np.ones((B,), np.int64),
                           succeeded=np.zeros((B,), bool)) for _ in jobs]
    if not batch.buckets or not jobs:
        return results
    table, owners = _engine_table(jobs, batch, k)
    # One host read for every lane's outcome.
    out = ops.fleet_engine(table, machine_memory, float(dt),
                           max_attempts).cpu().numpy()
    w, att, succ = out[0].view(np.float32), out[1], out[2] != 0
    for (j, idx), lo, hi in zip(owners, table.lane0[:-1], table.lane0[1:]):
        res = results[j]
        res.wastage_gbs[idx] = w[lo:hi]
        res.attempts[idx] = att[lo:hi]
        res.succeeded[idx] = succ[lo:hi]
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
