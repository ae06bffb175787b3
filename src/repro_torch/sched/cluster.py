"""Batched discrete-event cluster simulator with packed memory envelopes.

This is the paper's deployment context: a resource manager packs workflow
tasks onto nodes using each task's *memory envelope over time*.  KS+'s
envelopes free the unused head-room of early segments for other tasks —
the wastage reduction translates directly into throughput.

The simulator is discrete-event: nodes admit a queued job when the job's
allocation envelope fits under the node's *residual envelope* for the whole
projected runtime; the OOM killer fires when a job's hidden trace exceeds
its own allocation, triggering the method's retry strategy.

Three engines share the event semantics:

* ``engine="fused"`` (default) — the packed layout below, with the
  per-event hot path moved onto the device: the admission of an event is
  one drain program over every (node, queued job) pair at once
  (:class:`repro_torch.sched.admission.AdmissionState` — device-resident
  packed state in float64, in-place updates, and an incremental
  fits-column invalidation mask instead of full per-admission recompute),
  and OOM retries that land at the same event time are compacted into one
  multi-row :func:`retry_packed` / re-probe slice instead of one Python
  round-trip per lane.
* ``engine="packed"`` — all job plans live in one packed ``(B, K)``
  envelope batch (:mod:`repro_torch.core.envelope`); the admission check
  is a single vectorized fits-under-residual reduction across every queued
  job per node on the host, OOM times come from the batched attempt-#1
  probe, wastage is O(K) span arithmetic, and retry re-plans flow through
  :class:`RetrySpec` / :func:`retry_packed`.  Kept as the host-side
  float64 reference the fused engine is held to.
* ``engine="legacy"`` — the original per-job Python event loop, kept as the
  decision-for-decision oracle the packed engine is tested against.

The batched engines' attempt-#1 probe is one table of the job traces per
dt group, uploaded to ``device`` once per workload, and one
:func:`repro_torch.kernels.wastage.ops.oom_probe_groups` call per group: on
the card, one launch of the hand-written ``oom_probe`` kernel and one host
read per dt group; on the CPU its plain version.  ``device=None`` means
the card, and without CUDA that raises.

Precision contract: the batched engines' attempt-#1 OOM probe runs on the
device in float32 (that is what makes it one launch over the whole
workload); post-retry probes, admission residuals and wastage stay in
float64.  The two engines therefore agree bitwise whenever trace-vs-plan
margins exceed float32 resolution (~1e-7 relative) — true for the
differential workloads and for any real monitoring data, but a trace that
grazes its allocation within one float32 ulp may OOM under one engine and
not the other.

Fused-admission precision contract: the fused engine keeps the float32
attempt-#1 probe AND the float64 post-retry probes/wastage of the packed
engine; its admission residuals run in float64 *on the device* with the
same elementwise operations as the host path.  The only permitted
divergence is the summation order over a node's resident envelopes (numpy
reduces linearly, a device reduction need not) — last-ulp (~1e-16
relative) residual differences, so an admission decision can only flip
when a job's need grazes the residual within one float64 ulp of the 1e-9
admission tolerance.  The parity tests hold the two engines' placement
logs bitwise on workloads with real margins.

``run(offsets=[...])`` sweeps peak/start safety offsets and
``last_peak_bump`` the way :class:`KSPlusAuto` sweeps k: plans are re-packed
per candidate (cheap) while the trace tables stay device-resident and each
candidate's OOM probes are one launch per dt group over them.  Per-family
``offsets={family: OffsetCandidate}`` mappings may now disagree on *every*
field including ``last_peak_bump`` — bumps fold into a per-lane array that
rides :func:`repro_torch.core.envelope.retry_packed`'s ``bump`` axis.

Workflow DAGs: jobs may carry ``parents`` (jids that must *finish* first).
All three engines drive the same dependency-release frontier
(:class:`_DagFrontier`): only released jobs enter the admission queue, a
``done`` event releases its children at that event time, and a permanent
failure (unsatisfiable / out of attempts) counts every not-yet-released
descendant as unschedulable.  Cycles, self-parents, duplicate and unknown
job ids are rejected loudly at submit time with the offending ids named.

Arrivals and faults: jobs may carry ``release_time`` (no engine admits a
job before it; a child released before its parents finish simply waits
for them), and ``run(faults=...)`` injects a
:class:`repro_torch.sched.faults.FaultSchedule` of node leave/join events into
all three engines.  A leave evicts the node's residents in admission
order — each evicted job's allocated area up to the eviction time counts
as wastage, its attempt counter advances against the same
``max_attempts`` budget as OOM retries (``ClusterResult.evictions``
breaks the count out), and it requeues ahead of other waiters; running
out of attempts through evictions dooms DAG descendants exactly like an
OOM (``ClusterResult.doomed``).  Jobs the surviving fleet can never fit
park in a starvation-tracked side queue and re-enter on the next join
(``ClusterResult.starved`` / ``starvation_s``).  Unknown-node leaves
raise ``KeyError`` and joins of active nodes raise ``ValueError``, both
naming the node.  Oversized attempt-1 plans are rejected at submit time.

Eviction precision contract: eviction *decisions* (victim order, requeue
position, attempt/doom accounting, subsequent placements) are bitwise
across engines — they involve no new arithmetic, only the shared event
protocol.  Eviction *wastage* is the plan's area over the whole samples
elapsed since admission: the batched engines evaluate it with the same
O(K) span arithmetic as done/OOM wastage, the legacy loop with
per-sample float64 sums — within 1e-6 relative, the existing wastage
contract.  Under faults, ``avg_utilization``'s denominator becomes the
piecewise-constant capacity integral; without them it stays the
closed-form product, bit-for-bit the pre-fault result.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.analysis.contracts import record_dispatch
from repro_torch.core import AllocationPlan, alloc_at, first_violation
from repro_torch.core.envelope import (
    PAD_START,
    OffsetCandidate,
    PackedEnvelopes,
    RetrySpec,
    alloc_at_packed,
    apply_offsets,
    first_violation_packed,
    fits_under,
    residual_over,
    retry_packed,
    segment_sample_bounds,
    span_alloc_sum,
)
from repro_torch.core.fleet import pack_traces
from repro_torch.core.retry import apply_retry_spec
from repro_torch.device import process_world, resolve_device
from repro_torch.kernels.wastage import ops
from repro_torch.obs import metrics as _met
from repro_torch.obs import trace as _obs
from repro_torch.sched.admission import AdmissionState
from repro_torch.sched.faults import FaultEvent, FaultSchedule

__all__ = ["Job", "Node", "ClusterSim", "ClusterResult", "OffsetCandidate",
           "FaultEvent", "FaultSchedule"]

ADMIT_GRID = 64  # samples on the admission horizon (both engines)

RetryFn = Callable[[AllocationPlan, float, float], AllocationPlan]


def _norm_faults(faults) -> Tuple[FaultEvent, ...]:
    """Normalize a ``faults`` argument into a stably time-sorted tuple."""
    if faults is None:
        return ()
    if isinstance(faults, FaultSchedule):
        return faults.events
    events = tuple(faults)
    for e in events:
        if not isinstance(e, FaultEvent):
            raise TypeError(f"not a FaultEvent: {e!r}")
    return tuple(sorted(events, key=lambda e: e.t))


def _elapsed_samples(t: float, t0: float, dt: float, length: int) -> int:
    """Whole trace samples a job occupied between admission at ``t0`` and
    eviction at ``t`` — the span its eviction wastage covers.  Identical
    float arithmetic in every engine (the differential contract)."""
    return min(int(np.floor((float(t) - float(t0)) / float(dt) + 1e-9)),
               int(length))


@dataclasses.dataclass
class Job:
    jid: int
    family: str
    input_gb: float
    mem: np.ndarray          # hidden ground-truth trace (GB per dt)
    dt: float
    plan: AllocationPlan     # current allocation envelope
    est_runtime: float       # scheduler-facing runtime estimate
    attempts: int = 0
    wasted_gbs: float = 0.0
    # Workflow DAG edges: jids of jobs that must *finish* before this one
    # becomes admissible (empty = released at t=0, the historical behavior).
    parents: Tuple[int, ...] = ()
    # Absolute submission time: the job enters the admission queue at
    # max(release_time, all parents finished).  0.0 = the historical
    # released-at-start behavior; see repro_torch.workloads.arrivals for seeded
    # arrival processes.
    release_time: float = 0.0

    @property
    def runtime(self) -> float:
        return len(self.mem) * self.dt


class _DagFrontier:
    """Dependency-release frontier shared by all three engines.

    Built (and validated — loudly) at submit time from each job's
    ``parents``; a job enters the admission queue only once every parent
    has *finished*.  An OOM kill re-queues the killed job itself (its
    parents already finished) but never re-blocks released children; a
    *permanent* failure (unsatisfiable / out of attempts) dooms every
    not-yet-released descendant — they are counted unschedulable and never
    placed.  All three engines drive the same object the same way, so the
    differential suites keep pinning their decision logs bitwise.
    """

    def __init__(self, jobs: List[Job]):
        # One validator for every DAG surface (duplicates, self-parents,
        # unknown parents, cycles — each named loudly); the wfcommons
        # importer runs the same code over string task ids.
        from repro_torch.workloads.wfc import validate_dag_ids
        jids = [job.jid for job in jobs]
        validate_dag_ids(jids, [job.parents for job in jobs], kind="job")
        self.index: Dict[int, int] = {jid: i for i, jid in enumerate(jids)}
        B = len(jobs)
        self.pending = np.zeros((B,), np.int64)   # unfinished parent count
        self.children: List[List[int]] = [[] for _ in range(B)]
        self.dead = np.zeros((B,), bool)
        for i, job in enumerate(jobs):
            for p in dict.fromkeys(job.parents):  # dedupe, keep order
                self.children[self.index[p]].append(i)
                self.pending[i] += 1

    @classmethod
    def build(cls, jobs: List[Job]) -> Optional["_DagFrontier"]:
        """A fresh frontier, or ``None`` for dependency-free workloads."""
        if not any(job.parents for job in jobs):
            return None
        return cls(jobs)

    def roots(self) -> List[int]:
        return [i for i in range(len(self.pending)) if self.pending[i] == 0]

    def release(self, i: int) -> List[int]:
        """Job index ``i`` finished; returns newly admissible job indices
        (in the deterministic submission-order the engines share)."""
        out = []
        for c in self.children[i]:
            self.pending[c] -= 1
            if self.pending[c] == 0 and not self.dead[c]:
                out.append(c)
        return out

    def doom(self, i: int) -> int:
        """Job index ``i`` failed permanently: mark every not-yet-released
        descendant dead; returns how many (each counts unschedulable)."""
        count = 0
        stack = list(self.children[i])
        while stack:
            c = stack.pop()
            if self.dead[c]:
                continue
            self.dead[c] = True
            count += 1
            stack.extend(self.children[c])
        return count


class _LaneQueue:
    """Admission queue over lane indices with O(1) removal.

    Replaces the fused engine's plain Python list, whose per-placement
    ``queue.remove(ji)`` and per-event ``[q for q in queue ...]`` parking
    rescan made a busy drain O(Q²): membership lives in a numpy index
    mask, removals mark entries dead in O(1), and the order list compacts
    lazily on the next :meth:`ids` snapshot — amortized linear over a
    replay.  Order semantics match the list exactly (append at the back,
    evicted/unparked lanes pushed to the front in their given order,
    removals preserve the relative order of survivors), which is what
    keeps the placement logs bitwise against the oracles.
    """

    __slots__ = ("_order", "_in", "_tok", "_dead")

    def __init__(self, B: int):
        # Each (lane, token) entry is live iff the lane is queued AND the
        # token matches the lane's latest enqueue — a lane that is
        # admitted, OOMs, and re-queues must NOT resurrect its stale
        # (earlier) position in the order list.
        self._order: List[Tuple[int, int]] = []
        self._in = np.zeros(B, bool)
        self._tok = np.zeros(B, np.int64)
        self._dead = 0

    def __len__(self) -> int:
        return len(self._order) - self._dead

    def append(self, ji: int):
        self._tok[ji] += 1
        self._order.append((ji, int(self._tok[ji])))
        self._in[ji] = True

    def push_front(self, lanes: Sequence[int]):
        lanes = [int(ji) for ji in lanes]
        if not lanes:
            return
        self._compact()
        self._tok[lanes] += 1
        self._order[0:0] = [(ji, int(self._tok[ji])) for ji in lanes]
        self._in[lanes] = True

    def remove(self, ji: int):
        self._in[ji] = False
        self._dead += 1

    def remove_many(self, lanes) -> None:
        n = 0
        for ji in lanes:
            self._in[int(ji)] = False
            n += 1
        self._dead += n

    def ids(self) -> np.ndarray:
        """Current queue order as an index array (compacts if needed)."""
        self._compact()
        return np.asarray([ji for ji, _ in self._order], np.int64)

    def _compact(self):
        if self._dead:
            inq, tok = self._in, self._tok
            self._order = [(ji, tk) for ji, tk in self._order
                           if inq[ji] and tok[ji] == tk]
            self._dead = 0


@dataclasses.dataclass
class Node:
    nid: int
    capacity_gb: float
    running: List[Tuple[float, "Job"]] = dataclasses.field(
        default_factory=list)

    def residual_at(self, t_abs: float, horizon: np.ndarray) -> np.ndarray:
        """Residual capacity over ``horizon`` (absolute times)."""
        used = np.zeros_like(horizon)
        for start, job in self.running:
            rel = horizon - start
            active = (rel >= 0) & (rel < job.runtime + 1e-9)
            used += np.where(active, alloc_at(job.plan, np.maximum(rel, 0)),
                             0.0)
        return self.capacity_gb - used

    def fits(self, job: Job, t_abs: float) -> bool:
        horizon = t_abs + np.linspace(0, job.est_runtime, ADMIT_GRID)
        resid = self.residual_at(t_abs, horizon)
        need = alloc_at(job.plan, np.linspace(0, job.est_runtime, ADMIT_GRID))
        return bool(np.all(need <= resid + 1e-9))


@dataclasses.dataclass
class ClusterResult:
    makespan: float
    total_wastage_gbs: float
    retries: int
    unschedulable: int
    avg_utilization: float
    # Admission log: (t, nid, jid) per placement, in decision order.  The
    # differential test and the cluster_sim benchmark compare these bitwise.
    placements: Optional[List[Tuple[float, int, int]]] = None
    offset: Optional[OffsetCandidate] = None
    # Fault-injection accounting (all zero without a FaultSchedule):
    evictions: int = 0       # jobs killed by node departures
    doomed: int = 0          # DAG descendants of permanent failures
    #   (already included in ``unschedulable``; broken out for the suite)
    starved: int = 0         # jobs never finished nor failed (parked/queued)
    starvation_s: float = 0.0  # total time jobs spent parked (unfittable)
    finished: int = 0        # jobs that ran to completion


def _as_spec(retry) -> Tuple[Optional[RetrySpec], Optional[RetryFn]]:
    """Normalize a retry argument into (spec, callable) — exactly one set.

    Accepts a :class:`RetrySpec`, a RetrySpec kind string, a registered
    method *name* (``"ks+"`` — resolved to that method's retry rule through
    :mod:`repro_torch.core.registry`), a fitted method instance (its
    ``retry_spec`` is used), or a legacy ``(plan, t_fail, used)`` callable.
    """
    if isinstance(retry, RetrySpec):
        return retry, None
    if isinstance(retry, str):
        from repro_torch.core import registry
        spec = registry.try_retry_spec(retry)
        return (spec if spec is not None else RetrySpec(retry)), None
    if hasattr(retry, "retry_spec"):  # a MemoryPredictor-like method object
        return retry.retry_spec, None
    return None, retry


class ClusterSim:
    """Packs jobs (method-agnostic) and replays hidden traces with OOM.

    ``retry`` (in :meth:`run`) is either a static :class:`RetrySpec` —
    the vectorized path, required for offset sweeps of ``last_peak_bump`` —
    or a legacy ``(plan, t_fail, used) -> plan`` callable.

    ``device`` (None means the card) is where the batched engines' traces,
    attempt-#1 probes and the fused engine's admission state live.
    :attr:`stats` holds the last :meth:`run`'s counts: ``probe_groups`` (dt
    groups probed, one launch each on the card; per offset candidate) and,
    for the fused engine, the admission state's ``drains``,
    ``drain_dispatches``, ``drain_iterations``, ``host_reads`` and
    ``collectives`` (those of a sharded drain, ``shard=n``: see
    :class:`repro_torch.sched.admission.AdmissionState`).
    """

    def __init__(self, nodes: List[Node], max_attempts: int = 20,
                 engine: str = "fused", drain: str = "device",
                 shard: Optional[int] = None, device=None):
        if engine not in ("fused", "packed", "legacy"):
            raise ValueError(f"unknown engine: {engine!r}")
        if drain not in ("device", "host"):
            raise ValueError(f"unknown drain mode: {drain!r}")
        if shard is not None and drain != "device":
            raise ValueError("shard= requires drain='device'")
        self.nodes = nodes
        self.max_attempts = max_attempts
        self.engine = engine
        # Fused-engine drain mode: "device" runs the whole greedy drain as
        # the device program of AdmissionState.drain; "host" keeps the
        # per-placement columns/argmax loop as the decision oracle.
        # ``shard`` splits the drain's node axis over the ranks of a
        # process group of that size (every rank runs the same replay;
        # ``shard=1`` without a group runs over a one-rank group held for
        # the replay).  Both are ignored by the packed and legacy engines.
        self.drain = drain
        self.shard = shard
        self.device = resolve_device(device)
        self.stats: Dict[str, int] = {}

    # ------------------------------------------------------------------ API
    def _validate_submit(self, jobs: List[Job]) -> None:
        """Fail fast, loudly, at submit time.

        A job whose attempt-1 plan peak exceeds the largest node's
        capacity can never be placed — rejecting it here (naming the job
        ids) beats discovering a permanent failure mid-replay.  Release
        times must be finite and non-negative.
        """
        if not self.nodes:
            raise ValueError("cluster has no nodes")
        cap0 = max(n.capacity_gb for n in self.nodes)
        bad = [job.jid for job in jobs
               if float(np.max(job.plan.peaks)) > cap0 + 1e-9]
        if bad:
            raise ValueError(
                f"unschedulable at submit: attempt-1 plan peak exceeds the "
                f"largest node capacity ({cap0:g} GB) for job ids {bad}")
        bad = [job.jid for job in jobs
               if not np.isfinite(job.release_time)
               or job.release_time < 0.0]
        if bad:
            raise ValueError(
                f"release_time must be finite and >= 0 for job ids {bad}")

    def run(self, jobs: List[Job], retry,
            offsets: Union[None, str, Dict[str, OffsetCandidate],
                           Sequence[OffsetCandidate]] = None,
            faults: Union[None, FaultSchedule,
                          Sequence[FaultEvent]] = None,
            trace: bool = False
            ) -> Union[ClusterResult, List[ClusterResult]]:
        """Replay ``jobs`` through the cluster; see the module docstring.

        ``trace=True`` scope-enables :mod:`repro_torch.obs` tracing for
        the replay (restoring the previous state afterwards); when tracing
        is already enabled the replay is spanned either way.  Tracing only
        observes — placements/retries/evictions are bitwise identical
        traced or untraced (``tests/test_torch_obs.py``).

        Without ``offsets`` returns one :class:`ClusterResult` and mutates
        the ``Job`` objects (attempts / wasted_gbs / plan) like the legacy
        loop always did.  With a sequence of ``offsets`` returns one result
        per :class:`OffsetCandidate` — jobs are *not* mutated; each
        candidate replays the same workload with re-packed plans while the
        trace batch (and its device copy) is shared across the sweep.

        ``offsets="auto"`` sweeps the registry's default candidate grid
        (:data:`repro_torch.core.registry.DEFAULT_OFFSET_GRID`) and returns
        only the lowest-wastage result; ``offsets={family:
        OffsetCandidate}`` applies *per-task-family* candidates (e.g. the
        output of :func:`repro_torch.core.registry.tune_offset` per family)
        in one replay — families absent from the mapping run at identity.

        ``faults`` injects a :class:`repro_torch.sched.faults.FaultSchedule`
        (or a plain event sequence) of node leave/join events; all three
        engines replay it identically — evictions, requeue-with-backoff,
        doomed-descendant accounting and starvation parking included.
        """
        if trace and not _obs.enabled:
            with _obs.tracing():
                return self.run(jobs, retry, offsets, faults)
        if _obs.enabled:
            with _obs.span("cluster.run", engine=self.engine,
                           drain=self.drain, jobs=len(jobs)):
                return self._run_impl(jobs, retry, offsets, faults)
        return self._run_impl(jobs, retry, offsets, faults)

    def _run_impl(self, jobs: List[Job], retry, offsets, faults
                  ) -> Union[ClusterResult, List[ClusterResult]]:
        faults = _norm_faults(faults)
        self._validate_submit(jobs)
        self.stats = {}
        if self.shard == 1 and self.engine == "fused":
            with process_world(self.device):
                return self._run_engines(jobs, retry, offsets, faults)
        return self._run_engines(jobs, retry, offsets, faults)

    def _run_engines(self, jobs: List[Job], retry, offsets, faults
                     ) -> Union[ClusterResult, List[ClusterResult]]:
        if self.engine == "legacy":
            if offsets is not None:
                raise ValueError("offset sweeps require a batched engine")
            return self._run_legacy(jobs, retry, faults)
        run_one = (self._run_fused if self.engine == "fused"
                   else self._run_packed)
        if offsets is None:
            return run_one(jobs, retry, None, None, write_back=True,
                           faults=faults)
        if isinstance(offsets, str):
            if offsets != "auto":
                raise ValueError(f"unknown offsets mode: {offsets!r}")
            from repro_torch.core.registry import DEFAULT_OFFSET_GRID
            offsets = DEFAULT_OFFSET_GRID
            shared = self._pack_shared(jobs)
            sweep = [run_one(jobs, retry, cand, shared, write_back=False,
                             faults=faults)
                     for cand in offsets]
            return min(sweep, key=lambda r: r.total_wastage_gbs)
        if isinstance(offsets, dict):
            cand = self._family_offsets(jobs, offsets)
            return run_one(jobs, retry, cand, None, write_back=False,
                           faults=faults)
        shared = self._pack_shared(jobs)
        return [run_one(jobs, retry, cand, shared, write_back=False,
                        faults=faults)
                for cand in offsets]

    @staticmethod
    def _family_offsets(jobs: List[Job],
                        mapping: Dict[str, OffsetCandidate]
                        ) -> OffsetCandidate:
        """Fold a per-family candidate mapping into one per-lane candidate.

        ``peak``/``start``/``last_peak_bump`` all become per-lane arrays
        (identity for families not in the mapping): per-family
        :func:`repro_torch.core.registry.tune_offset` winners may disagree on
        every field, including the ksplus last-peak bump — unmapped lanes
        get NaN bumps, which fall back to the retry spec's static value
        inside :func:`repro_torch.core.envelope.retry_packed`.
        """
        families = {job.family for job in jobs}
        unknown = set(mapping) - families
        if unknown:
            raise ValueError(
                f"offset mapping names unknown families: {sorted(unknown)} "
                f"(workload families: {sorted(families)})")
        peak = np.zeros((len(jobs),), np.float64)
        start = np.zeros((len(jobs),), np.float64)
        bump = np.full((len(jobs),), np.nan, np.float64)
        any_bump = False
        for i, job in enumerate(jobs):
            c = mapping.get(job.family)
            if c is not None:
                peak[i] = c.peak
                start[i] = c.start
                if c.last_peak_bump is not None:
                    bump[i] = c.last_peak_bump
                    any_bump = True
        return OffsetCandidate(peak=peak, start=start,
                               last_peak_bump=(bump if any_bump else None))

    # ---------------------------------------------------------- legacy loop
    def _run_legacy(self, jobs: List[Job], retry,
                    faults: Tuple[FaultEvent, ...] = ()) -> ClusterResult:
        spec, retry_fn = _as_spec(retry)
        if retry_fn is None:
            # RetrySpec rules that reference "the machine" (max-machine,
            # double's cap) are bounded by the largest node in this cluster.
            cap_max = max(n.capacity_gb for n in self.nodes)

            def retry_fn(plan, t_fail, used, _spec=spec, _cap=cap_max):
                return apply_retry_spec(_spec, plan, t_fail, used,
                                        machine_memory=_cap)
        frontier = _DagFrontier.build(jobs)
        active: List[Node] = list(self.nodes)
        by_nid: Dict[int, Node] = {n.nid: n for n in active}
        epoch: Dict[int, int] = {job.jid: 0 for job in jobs}
        queue: List[Job] = []
        parked: List[Job] = []
        park_t: Dict[int, float] = {}
        need_cache: Dict[int, float] = {}
        events: List[Tuple[float, int, str, int, object, int]] = []
        seq = itertools.count()
        retries = 0
        unschedulable = 0
        evictions = 0
        doomed = 0
        finished = 0
        starvation_s = 0.0
        area_used = 0.0
        done_at = 0.0
        last_t = 0.0
        placements: List[Tuple[float, int, int]] = []
        have_faults = bool(faults)
        cap_sum = float(sum(n.capacity_gb for n in active))
        cap_integral = 0.0
        cap_last = 0.0

        for i in (range(len(jobs)) if frontier is None
                  else frontier.roots()):
            job = jobs[i]
            if job.release_time > 0.0:
                heapq.heappush(events, (float(job.release_time), next(seq),
                                        "arrive", -1, job, 0))
            else:
                queue.append(job)
        for fe in faults:
            heapq.heappush(events, (float(fe.t), next(seq), fe.kind,
                                    int(fe.nid), fe, 0))

        def need_peak(job: Job) -> float:
            """Peak of the admission-need row (invalidated on re-plan) —
            the packed engines' ``need.max(axis=1)``, one job at a time."""
            v = need_cache.get(job.jid)
            if v is None:
                v = float(np.max(alloc_at(
                    job.plan,
                    np.linspace(0.0, job.est_runtime, ADMIT_GRID))))
                need_cache[job.jid] = v
            return v

        def try_admit(now: float):
            # Graceful degradation: a job no surviving node could *ever*
            # fit parks in a starvation-tracked side queue (it re-enters
            # on the next join) instead of spinning in the scan below.
            if queue:
                cap_hi = max((n.capacity_gb for n in active), default=0.0)
                for job in [j for j in queue
                            if need_peak(j) > cap_hi + 1e-9]:
                    queue.remove(job)
                    parked.append(job)
                    park_t[job.jid] = now
            admitted = True
            while admitted and queue:
                admitted = False
                for job in list(queue):
                    for node in active:
                        if node.fits(job, now):
                            queue.remove(job)
                            node.running.append((now, job))
                            placements.append((now, node.nid, job.jid))
                            v = first_violation(job.plan, job.mem, job.dt)
                            if v < 0:
                                end = now + job.runtime
                                heapq.heappush(
                                    events, (end, next(seq), "done",
                                             node.nid, job,
                                             epoch[job.jid]))
                            else:
                                heapq.heappush(
                                    events, (now + v * job.dt, next(seq),
                                             "oom", node.nid, job,
                                             epoch[job.jid]))
                            admitted = True
                            break

        def submit_child(c: int, now: float):
            child = jobs[c]
            if child.release_time > now:
                heapq.heappush(events, (float(child.release_time),
                                        next(seq), "arrive", -1, child, 0))
            else:
                queue.append(child)

        try_admit(0.0)
        guard = 0
        while events:
            guard += 1
            if guard > 200_000:
                raise RuntimeError("cluster sim did not converge")
            t, _, kind, nid, payload, ep = heapq.heappop(events)
            last_t = max(last_t, t)
            if kind in ("done", "oom"):
                job = payload
                if ep != epoch[job.jid]:
                    continue  # evicted since this event was scheduled
                node = by_nid[nid]
                node.running = [(s, j) for s, j in node.running
                                if j.jid != job.jid]
                if kind == "done":
                    alloc = alloc_at(job.plan,
                                     np.arange(len(job.mem)) * job.dt)
                    job.wasted_gbs += float(np.sum(alloc - job.mem) * job.dt)
                    area_used += float(np.sum(job.mem) * job.dt)
                    done_at = max(done_at, t)
                    finished += 1
                    if frontier is not None:  # dependency-release
                        for c in frontier.release(
                                frontier.index[job.jid]):
                            submit_child(c, t)
                else:  # OOM kill
                    v = first_violation(job.plan, job.mem, job.dt)
                    alloc = alloc_at(job.plan, np.arange(v + 1) * job.dt)
                    job.wasted_gbs += float(np.sum(alloc) * job.dt)
                    job.attempts += 1
                    retries += 1
                    if job.attempts >= self.max_attempts or \
                            float(np.max(job.mem)) > max(
                                n.capacity_gb for n in self.nodes):
                        unschedulable += 1
                        if frontier is not None:  # descendants blocked
                            d = frontier.doom(frontier.index[job.jid])
                            doomed += d
                            unschedulable += d
                    else:
                        job.plan = retry_fn(job.plan, v * job.dt,
                                            float(job.mem[v]))
                        need_cache.pop(job.jid, None)
                        queue.append(job)
                try_admit(t)
            elif kind == "arrive":
                job = payload
                if frontier is None or \
                        not frontier.dead[frontier.index[job.jid]]:
                    queue.append(job)
                try_admit(t)
            elif kind == "leave":
                pos = next((i for i, n in enumerate(active)
                            if n.nid == nid), -1)
                if pos < 0:
                    raise KeyError(
                        f"node_leave: unknown or inactive node {nid} "
                        f"at t={t:g}")
                cap_integral += cap_sum * (t - cap_last)
                cap_last = t
                node = active.pop(pos)
                cap_sum -= node.capacity_gb
                victims = list(node.running)
                node.running = []
                requeue: List[Job] = []
                for (s, job) in victims:
                    epoch[job.jid] += 1     # stale pending done/oom events
                    evictions += 1
                    e = _elapsed_samples(t, s, job.dt, len(job.mem))
                    alloc = alloc_at(job.plan, np.arange(e) * job.dt)
                    job.wasted_gbs += float(np.sum(alloc) * job.dt)
                    job.attempts += 1       # the RetrySpec attempt budget
                    if job.attempts >= self.max_attempts:
                        unschedulable += 1
                        if frontier is not None:
                            d = frontier.doom(frontier.index[job.jid])
                            doomed += d
                            unschedulable += d
                    else:
                        requeue.append(job)
                queue[0:0] = requeue  # evicted jobs go ahead of waiters
                try_admit(t)
            else:  # join
                if any(n.nid == nid for n in active):
                    raise ValueError(
                        f"node_join: node {nid} already active at t={t:g}")
                cap_integral += cap_sum * (t - cap_last)
                cap_last = t
                fe = payload
                node = Node(nid, float(fe.capacity_gb))
                by_nid[nid] = node
                active.append(node)
                cap_sum += node.capacity_gb
                if parked:  # unpark everything; the sweep re-parks misfits
                    for job in parked:
                        starvation_s += t - park_t.pop(job.jid)
                    queue[0:0] = parked
                    parked.clear()
                try_admit(t)

        for job in parked:
            starvation_s += last_t - park_t.pop(job.jid)
        if have_faults:
            end_t = max(done_at, cap_last)
            cap_integral += cap_sum * (end_t - cap_last)
            total_cap_area = max(cap_integral, 1e-9)
        else:
            total_cap_area = sum(
                n.capacity_gb for n in self.nodes) * max(done_at, 1e-9)
        return ClusterResult(
            makespan=done_at,
            total_wastage_gbs=sum(j.wasted_gbs for j in jobs),
            retries=retries,
            unschedulable=unschedulable,
            avg_utilization=area_used / total_cap_area,
            placements=placements,
            evictions=evictions,
            doomed=doomed,
            starved=len(jobs) - finished - unschedulable,
            starvation_s=starvation_s,
            finished=finished,
        )

    # ---------------------------------------------------------- packed loop
    def _pack_shared(self, jobs: List[Job]):
        """Per-dt trace groups, uploaded to the device once per workload.

        Each group's traces are padded to one power-of-two length
        (:func:`repro_torch.core.fleet.pack_traces`) and go up in one copy
        of the rows and one of the lengths; every offset candidate's
        attempt-#1 probe reads these resident tensors — the ``(B, T)``
        trace batch is by far the largest operand, so keeping it resident
        is what makes the sweep cheap.
        """
        by_dt: Dict[float, List[int]] = {}
        for i, job in enumerate(jobs):
            by_dt.setdefault(float(job.dt), []).append(i)
        groups = []
        for dtv in sorted(by_dt):
            idxs = np.asarray(by_dt[dtv], np.int64)
            pt = pack_traces([jobs[i].mem for i in idxs])
            groups.append((dtv, idxs,
                           torch.from_numpy(pt.mems).to(self.device),
                           torch.from_numpy(pt.lengths).to(self.device)))
        return groups

    def _initial_viol(self, starts, peaks, groups, B: int) -> np.ndarray:
        """Attempt-#1 OOM probe for every lane, in float32: per dt group
        one table of the group's plans over its resident traces and one
        :func:`~repro_torch.kernels.wastage.ops.oom_probe_groups` call (one
        kernel launch on the card) and one host read."""
        viol = np.empty((B,), np.int64)
        for dtv, idxs, dmems, dlengths in groups:
            table = ops.GroupTable([ops.Group(
                np.ascontiguousarray(starts[idxs], np.float32),
                np.ascontiguousarray(peaks[idxs], np.float32),
                dmems, dlengths)], self.device)
            record_dispatch("cluster.first_attempt")
            v, _, _ = ops.oom_probe_groups(table, dtv)
            viol[idxs] = v.cpu().numpy()
        self.stats["probe_groups"] = self.stats.get("probe_groups", 0) \
            + len(groups)
        return viol

    @staticmethod
    def _apply_offset(env: PackedEnvelopes, cand: OffsetCandidate):
        """Re-pack the plan batch under one offset candidate (cheap: O(BK));
        see :func:`repro_torch.core.envelope.apply_offsets` — scalar (sweep)
        and per-lane (per-family mapping) candidates both land here."""
        return apply_offsets(env.starts, env.peaks, env.nseg, cand)

    def _prep_packed(self, jobs: List[Job], retry,
                     offset: Optional[OffsetCandidate], shared):
        """Shared packed-engine setup (plans, grids, probes) — used
        verbatim by both the host-side packed loop and the fused loop so
        the two engines start from identical state."""
        if any(node.running for node in self.nodes):
            # Resident jobs live outside the packed batch; admitting around
            # them silently would diverge from the legacy loop.
            raise ValueError(
                "batched engines require empty Node.running; submit "
                "resident jobs as part of `jobs` or use engine='legacy'")
        spec, retry_fn = _as_spec(retry)
        bump_lanes = None
        if offset is not None and offset.last_peak_bump is not None:
            if spec is None:
                raise ValueError(
                    "sweeping last_peak_bump requires a RetrySpec retry")
            lb = np.asarray(offset.last_peak_bump, np.float64)
            if lb.ndim == 0:
                spec = spec._replace(bump=float(lb))
            else:  # per-lane bumps; NaN = keep the spec's static value
                bump_lanes = np.where(np.isnan(lb), spec.bump, lb)

        B = len(jobs)
        env = PackedEnvelopes.from_plans([j.plan for j in jobs])
        if offset is None:
            starts, peaks = env.starts.copy(), env.peaks.copy()
        else:
            starts, peaks = self._apply_offset(env, offset)
        nseg = env.nseg
        K = starts.shape[1]

        # Per-job static state (float64 host arrays).
        dts = np.asarray([j.dt for j in jobs], np.float64)
        lengths = np.asarray([len(j.mem) for j in jobs], np.int64)
        runtimes = lengths * dts
        est = np.asarray([j.est_runtime for j in jobs], np.float64)
        summem = np.asarray(
            [j.mem.sum(dtype=np.float64) for j in jobs], np.float64)
        peak_demand = np.asarray(
            [float(np.max(j.mem)) for j in jobs], np.float64)
        caps = np.asarray([n.capacity_gb for n in self.nodes], np.float64)
        cap_max = float(caps.max())
        # Admission horizon grids (B, G) — the legacy per-job linspace,
        # evaluated for every job at once.
        grid_rel = np.linspace(0.0, est, ADMIT_GRID, axis=1)
        need = alloc_at_packed(starts, peaks, grid_rel)
        bounds = segment_sample_bounds(starts, dts[:, None])

        # Attempt-#1 OOM probe, one batched launch per dt group.
        shared = shared if shared is not None else self._pack_shared(jobs)
        viol = self._initial_viol(starts, peaks, shared, B)
        return (spec, retry_fn, bump_lanes, starts, peaks, nseg, K, dts,
                lengths, runtimes, summem, peak_demand, caps, cap_max,
                grid_rel, need, bounds, viol)

    def _run_packed(self, jobs: List[Job], retry,
                    offset: Optional[OffsetCandidate], shared,
                    write_back: bool,
                    faults: Tuple[FaultEvent, ...] = ()) -> ClusterResult:
        if not jobs:
            return ClusterResult(0.0, 0.0, 0, 0, 0.0, placements=[],
                                 offset=offset)
        (spec, retry_fn, bump_lanes, starts, peaks, nseg, K, dts, lengths,
         runtimes, summem, peak_demand, caps, cap_max, grid_rel, need,
         bounds, viol) = self._prep_packed(jobs, retry, offset, shared)
        B = len(jobs)

        # Mutable replay state.  attempts/wastage continue from the Job
        # counters, exactly like the legacy loop's in-place accumulation.
        attempts0 = np.asarray([j.attempts for j in jobs], np.int64)
        attempts = attempts0.copy()
        wasted = np.asarray([j.wasted_gbs for j in jobs], np.float64)
        release = np.asarray([j.release_time for j in jobs], np.float64)
        need_max = need.max(axis=1)
        # Fleet membership: events carry the stable ``nid``; positions in
        # these parallel lists shift under churn (leaves splice, joins
        # append — the same order the legacy loop's ``active`` keeps).
        active_nids: List[int] = [n.nid for n in self.nodes]
        caps_act = caps.copy()
        node_running: List[List[int]] = [[] for _ in active_nids]
        admit_t = np.zeros((B,), np.float64)
        epoch = np.zeros((B,), np.int64)
        frontier = _DagFrontier.build(jobs)
        queue: List[int] = []
        parked: List[int] = []
        park_t: Dict[int, float] = {}
        events: List[Tuple[float, int, str, int, object, int]] = []
        seq = itertools.count()
        retries = 0
        unschedulable = 0
        evictions = 0
        doomed = 0
        finished = 0
        starvation_s = 0.0
        area_used = 0.0
        done_at = 0.0
        last_t = 0.0
        placements: List[Tuple[float, int, int]] = []
        have_faults = bool(faults)
        cap_sum = float(caps_act.sum())
        cap_integral = 0.0
        cap_last = 0.0

        for ji in (range(B) if frontier is None else frontier.roots()):
            if release[ji] > 0.0:
                heapq.heappush(events, (float(release[ji]), next(seq),
                                        "arrive", -1, ji, 0))
            else:
                queue.append(ji)
        for fe in faults:
            heapq.heappush(events, (float(fe.t), next(seq), fe.kind,
                                    int(fe.nid), fe, 0))

        def fits_column(ni: int, q: List[int], now: float) -> Dict[int, bool]:
            """Admission predicate for every queued job vs node ``ni`` at
            ``now`` — one vectorized residual evaluation + reduction."""
            run = node_running[ni]
            grid_abs = now + grid_rel[q]
            resid = residual_over(
                caps_act[ni], starts[run], peaks[run], admit_t[run],
                grid_abs, dur=runtimes[run])
            ok = fits_under(need[q], resid)
            return dict(zip(q, ok.tolist()))

        def try_admit(now: float):
            if queue:  # park jobs no surviving node could ever fit
                cap_hi = float(caps_act.max()) if active_nids else 0.0
                for ji in [q for q in queue if need_max[q] > cap_hi + 1e-9]:
                    queue.remove(ji)
                    parked.append(ji)
                    park_t[ji] = now
            cols: Dict[int, Dict[int, bool]] = {}
            admitted = True
            while admitted and queue:
                admitted = False
                for ji in list(queue):
                    for ni in range(len(active_nids)):
                        col = cols.get(ni)
                        if col is None or ji not in col:
                            col = cols[ni] = fits_column(ni, list(queue), now)
                        if col[ji]:
                            queue.remove(ji)
                            node_running[ni].append(ji)
                            admit_t[ji] = now
                            cols.pop(ni, None)  # this node's residual changed
                            placements.append(
                                (float(now), active_nids[ni], jobs[ji].jid))
                            v = viol[ji]
                            if v < 0:
                                heapq.heappush(
                                    events, (now + runtimes[ji], next(seq),
                                             "done", active_nids[ni], ji,
                                             int(epoch[ji])))
                            else:
                                heapq.heappush(
                                    events, (now + v * dts[ji], next(seq),
                                             "oom", active_nids[ni], ji,
                                             int(epoch[ji])))
                            admitted = True
                            break

        try_admit(0.0)
        guard = 0
        while events:
            guard += 1
            if guard > 200_000:
                raise RuntimeError("cluster sim did not converge")
            t, _, kind, nid, payload, ep = heapq.heappop(events)
            last_t = max(last_t, t)
            if kind in ("done", "oom"):
                ji = payload
                if ep != epoch[ji]:
                    continue  # evicted since this event was scheduled
                node_running[active_nids.index(nid)].remove(ji)
                row = slice(ji, ji + 1)
                if kind == "done":
                    w = span_alloc_sum(peaks[row], bounds[row],
                                       lengths[row])[0]
                    wasted[ji] += (w - summem[ji]) * dts[ji]
                    area_used += summem[ji] * dts[ji]
                    done_at = max(done_at, t)
                    finished += 1
                    if frontier is not None:  # dependency-release
                        for c in frontier.release(ji):
                            if release[c] > t:
                                heapq.heappush(
                                    events, (float(release[c]), next(seq),
                                             "arrive", -1, c, 0))
                            else:
                                queue.append(c)
                else:  # OOM kill
                    v = int(viol[ji])
                    w = span_alloc_sum(peaks[row], bounds[row],
                                       np.asarray([v + 1]))[0]
                    wasted[ji] += w * dts[ji]
                    attempts[ji] += 1
                    retries += 1
                    if attempts[ji] >= self.max_attempts or \
                            peak_demand[ji] > cap_max:
                        unschedulable += 1
                        if frontier is not None:  # descendants blocked
                            d = frontier.doom(ji)
                            doomed += d
                            unschedulable += d
                    else:
                        t_fail = v * dts[ji]
                        used = float(jobs[ji].mem[v])
                        if spec is not None:
                            ns, npk = retry_packed(
                                spec, starts[row], peaks[row], nseg[row],
                                np.asarray([t_fail]), np.asarray([used]),
                                machine_memory=cap_max,
                                bump=(None if bump_lanes is None
                                      else bump_lanes[row]))
                            starts[ji], peaks[ji] = ns[0], npk[0]
                        else:
                            s, p = PackedEnvelopes(
                                starts, peaks, nseg).row(ji)
                            new = retry_fn(AllocationPlan(s, p), t_fail,
                                           used)
                            starts[ji, :new.n] = new.starts
                            starts[ji, new.n:] = PAD_START
                            peaks[ji, :new.n] = new.peaks
                            peaks[ji, new.n:] = new.peaks[-1]
                            nseg[ji] = new.n
                        # Refresh the lane's derived state (plan changed).
                        need[ji] = alloc_at_packed(
                            starts[row], peaks[row], grid_rel[row])[0]
                        need_max[ji] = need[ji].max()
                        bounds[ji] = segment_sample_bounds(
                            starts[row], dts[ji])[0]
                        viol[ji] = first_violation_packed(
                            starts[row], peaks[row],
                            np.asarray(jobs[ji].mem, np.float64)[None, :],
                            lengths[row], float(dts[ji]))[0]
                        queue.append(ji)
                try_admit(t)
            elif kind == "arrive":
                ji = payload
                if frontier is None or not frontier.dead[ji]:
                    queue.append(ji)
                try_admit(t)
            elif kind == "leave":
                if nid not in active_nids:
                    raise KeyError(
                        f"node_leave: unknown or inactive node {nid} "
                        f"at t={t:g}")
                cap_integral += cap_sum * (t - cap_last)
                cap_last = t
                pos = active_nids.index(nid)
                cap_sum -= float(caps_act[pos])
                caps_act = np.delete(caps_act, pos)
                victims = node_running.pop(pos)
                active_nids.pop(pos)
                requeue: List[int] = []
                for ji in victims:
                    epoch[ji] += 1      # stale pending done/oom events
                    evictions += 1
                    e = _elapsed_samples(t, admit_t[ji], dts[ji],
                                         lengths[ji])
                    w = span_alloc_sum(peaks[ji:ji + 1], bounds[ji:ji + 1],
                                       np.asarray([e]))[0]
                    wasted[ji] += w * dts[ji]
                    attempts[ji] += 1   # the RetrySpec attempt budget
                    if attempts[ji] >= self.max_attempts:
                        unschedulable += 1
                        if frontier is not None:
                            d = frontier.doom(ji)
                            doomed += d
                            unschedulable += d
                    else:
                        requeue.append(ji)
                queue[0:0] = requeue  # evicted jobs go ahead of waiters
                try_admit(t)
            else:  # join
                if nid in active_nids:
                    raise ValueError(
                        f"node_join: node {nid} already active at t={t:g}")
                cap_integral += cap_sum * (t - cap_last)
                cap_last = t
                fe = payload
                active_nids.append(nid)
                node_running.append([])
                caps_act = np.append(caps_act, float(fe.capacity_gb))
                cap_sum += float(fe.capacity_gb)
                if parked:  # unpark; the sweep re-parks misfits
                    for ji in parked:
                        starvation_s += t - park_t.pop(ji)
                    queue[0:0] = parked
                    parked.clear()
                try_admit(t)

        for ji in parked:
            starvation_s += last_t - park_t.pop(ji)
        if write_back:
            for i, job in enumerate(jobs):
                job.attempts = int(attempts[i])
                job.wasted_gbs = float(wasted[i])
                if attempts[i] > attempts0[i]:  # plan changed by retries
                    s, p = PackedEnvelopes(starts, peaks, nseg).row(i)
                    job.plan = AllocationPlan(starts=s, peaks=p)

        if have_faults:
            end_t = max(done_at, cap_last)
            cap_integral += cap_sum * (end_t - cap_last)
            total_cap_area = max(cap_integral, 1e-9)
        else:
            total_cap_area = float(caps.sum()) * max(done_at, 1e-9)
        return ClusterResult(
            makespan=done_at,
            total_wastage_gbs=float(wasted.sum()),
            retries=retries,
            unschedulable=unschedulable,
            avg_utilization=area_used / total_cap_area,
            placements=placements,
            offset=offset,
            evictions=evictions,
            doomed=doomed,
            starved=B - finished - unschedulable,
            starvation_s=starvation_s,
            finished=finished,
        )

    # ----------------------------------------------------------- fused loop
    def _run_fused(self, jobs: List[Job], retry,
                   offset: Optional[OffsetCandidate], shared,
                   write_back: bool,
                   admission_backend: str = "fused",
                   faults: Tuple[FaultEvent, ...] = ()) -> ClusterResult:
        """Packed event loop with the per-event admission on the device.

        Decision-for-decision identical to :meth:`_run_packed` (the parity
        tests hold the placement logs bitwise); differs in *how* the work
        is done:

        * admission — :class:`repro_torch.sched.admission.AdmissionState`:
          one float64 drain program per event on the device over every
          (node, queued lane) pair (``drain="device"``), or incremental
          recomputes of only the invalidated entries after each placement
          (``drain="host"``), instead of full per-node numpy columns per
          admission; ``admission_backend="numpy"`` runs the same protocol
          on the float64 host reference;
        * retries — all OOMs that land at the same event time are
          compacted into one multi-row ``retry_packed`` re-plan, one
          batched ``need``/``bounds`` refresh and one batched float64
          re-probe per dt group, instead of one 1-row slice per event.
        """
        if not jobs:
            return ClusterResult(0.0, 0.0, 0, 0, 0.0, placements=[],
                                 offset=offset)
        (spec, retry_fn, bump_lanes, starts, peaks, nseg, K, dts, lengths,
         runtimes, summem, peak_demand, caps, cap_max, grid_rel, need,
         bounds, viol) = self._prep_packed(jobs, retry, offset, shared)
        B = len(jobs)

        attempts0 = np.asarray([j.attempts for j in jobs], np.int64)
        attempts = attempts0.copy()
        wasted = np.asarray([j.wasted_gbs for j in jobs], np.float64)
        release = np.asarray([j.release_time for j in jobs], np.float64)
        need_max = need.max(axis=1)
        adm = AdmissionState(caps, K=K, G=ADMIT_GRID,
                             backend=admission_backend, use_dur=True,
                             shard=self.shard, device=self.device)
        adm.add_lanes(starts, peaks, need, grid_rel, dur=runtimes)
        device_drain = self.drain == "device"
        # Node rows in ``adm`` are positional; events carry the stable
        # ``nid`` and map through this list (leaves splice, joins append —
        # AdmissionState's remove_node/add_node row protocol).
        active_nids: List[int] = [n.nid for n in self.nodes]
        epoch = np.zeros((B,), np.int64)
        frontier = _DagFrontier.build(jobs)
        queue = _LaneQueue(B)
        parked: List[int] = []
        park_t: Dict[int, float] = {}
        events: List[Tuple[float, int, str, int, object, int]] = []
        seq = itertools.count()
        retries = 0
        unschedulable = 0
        evictions = 0
        doomed = 0
        finished = 0
        starvation_s = 0.0
        area_used = 0.0
        done_at = 0.0
        last_t = 0.0
        placements: List[Tuple[float, int, int]] = []
        have_faults = bool(faults)
        cap_sum = float(caps.sum())
        cap_integral = 0.0
        cap_last = 0.0

        for ji in (range(B) if frontier is None else frontier.roots()):
            if release[ji] > 0.0:
                heapq.heappush(events, (float(release[ji]), next(seq),
                                        "arrive", -1, ji, 0))
            else:
                queue.append(ji)
        for fe in faults:
            heapq.heappush(events, (float(fe.t), next(seq), fe.kind,
                                    int(fe.nid), fe, 0))

        def place_record(now: float, ni: int, ji: int):
            placements.append(
                (float(now), active_nids[ni], jobs[ji].jid))
            v = viol[ji]
            if v < 0:
                heapq.heappush(events, (now + runtimes[ji], next(seq),
                                        "done", active_nids[ni], ji,
                                        int(epoch[ji])))
            else:
                heapq.heappush(events, (now + v * dts[ji], next(seq),
                                        "oom", active_nids[ni], ji,
                                        int(epoch[ji])))

        def try_admit(now: float):
            """Greedy drain on the shared fits matrix.

            Decision-equivalent to the packed loop's job-by-job scan:
            admissions only shrink residuals, so an unfit job can never
            become fit within one drain — the first fitting job in queue
            order under the current state is exactly the next job the
            per-job scan would admit.

            With ``drain="device"`` the whole greedy loop — fits
            refresh, (queue, node)-order argmax, residual update,
            repeat — runs inside :meth:`AdmissionState.drain`, the
            device program returning the placement list.  The host
            fallback iterates here, one ``columns`` refresh per
            placement, and is held bitwise against the device path by
            the parity tests.
            """
            ids = queue.ids()
            if ids.size:  # park jobs no surviving node could ever fit
                cap_hi = float(adm.caps.max()) if adm.N else 0.0
                bad = need_max[ids] > cap_hi + 1e-9
                if bad.any():
                    drop = ids[bad]
                    queue.remove_many(drop)
                    for ji in drop.tolist():
                        parked.append(ji)
                        park_t[ji] = now
                    ids = ids[~bad]
            adm.sync_now(now)
            if device_drain:
                if ids.size == 0 or adm.N == 0:
                    return
                placed = adm.drain(now, ids)
                if placed:
                    queue.remove_many([ji for ji, _ in placed])
                    for ji, ni in placed:
                        place_record(now, ni, ji)
                return
            alive = np.ones(ids.size, bool)
            while alive.any():
                cur = ids[alive]
                adm.columns(now, cur)  # one refresh for invalid entries
                M = adm.fits[:, cur]   # (N, Q) — all entries now valid
                anyfit = M.any(axis=0)
                if not anyfit.any():
                    break
                col = int(np.argmax(anyfit))
                ni = int(np.argmax(M[:, col]))
                ji = int(cur[col])
                alive[np.nonzero(alive)[0][col]] = False
                queue.remove(ji)
                adm.place(ni, ji, now)
                place_record(now, ni, ji)

        def process_job_run(run_events):
            """One contiguous run of *fresh* done/oom events inside a
            same-time batch: stage wastage and compacted retries exactly
            like the pre-churn whole-batch path (no membership change can
            occur inside a run, so the staging stays decision-safe), then
            process the events one at a time."""
            nonlocal retries, unschedulable, doomed, finished
            nonlocal area_used, done_at
            # Stage wastage for the run against the *pre-retry* plans
            # (compacted multi-row span arithmetic).
            done_idx = [ev[4] for ev in run_events if ev[2] == "done"]
            oom_idx = [ev[4] for ev in run_events if ev[2] == "oom"]
            w_done: Dict[int, float] = {}
            w_oom: Dict[int, float] = {}
            if done_idx:
                rows = np.asarray(done_idx)
                w = span_alloc_sum(peaks[rows], bounds[rows], lengths[rows])
                w_done = dict(zip(done_idx, w))
            if oom_idx:
                rows = np.asarray(oom_idx)
                w = span_alloc_sum(peaks[rows], bounds[rows],
                                   viol[rows] + 1)
                w_oom = dict(zip(oom_idx, w))

            # Event-batched retries: compact the retrying minority into one
            # multi-row re-plan + refresh (lane-local, so staging it before
            # the per-event processing below cannot change any decision —
            # a lane only becomes visible to admission once it is queued).
            retry_set = [
                ji for ji in oom_idx
                if attempts[ji] + 1 < self.max_attempts
                and peak_demand[ji] <= cap_max]
            if retry_set:
                rows = np.asarray(retry_set)
                if spec is not None:
                    ns, npk = retry_packed(
                        spec, starts[rows], peaks[rows], nseg[rows],
                        viol[rows] * dts[rows],
                        np.asarray([float(jobs[ji].mem[viol[ji]])
                                    for ji in retry_set]),
                        machine_memory=cap_max,
                        bump=(None if bump_lanes is None
                              else bump_lanes[rows]))
                    starts[rows], peaks[rows] = ns, npk
                else:
                    for ji in retry_set:
                        s, p = PackedEnvelopes(starts, peaks, nseg).row(ji)
                        new = retry_fn(AllocationPlan(s, p),
                                       float(viol[ji] * dts[ji]),
                                       float(jobs[ji].mem[viol[ji]]))
                        starts[ji, :new.n] = new.starts
                        starts[ji, new.n:] = PAD_START
                        peaks[ji, :new.n] = new.peaks
                        peaks[ji, new.n:] = new.peaks[-1]
                        nseg[ji] = new.n
                # Refresh derived state for all retried lanes at once;
                # post-retry probes stay float64 (precision contract), one
                # batched pass per dt group.
                need[rows] = alloc_at_packed(
                    starts[rows], peaks[rows], grid_rel[rows])
                need_max[rows] = need[rows].max(axis=1)
                bounds[rows] = segment_sample_bounds(
                    starts[rows], dts[rows][:, None])
                by_dt: Dict[float, List[int]] = {}
                for ji in retry_set:
                    by_dt.setdefault(float(dts[ji]), []).append(ji)
                for dtv, lanes in by_dt.items():
                    g = np.asarray(lanes)
                    tmax = int(lengths[g].max())
                    mems = np.zeros((len(lanes), tmax), np.float64)
                    for r, ji in enumerate(lanes):
                        mems[r, :lengths[ji]] = jobs[ji].mem
                    viol[g] = first_violation_packed(
                        starts[g], peaks[g], mems, lengths[g], dtv)
                # NOTE: the admission state keeps each lane's OLD plan
                # until that lane's kill event is processed below — while
                # an OOMing job is still resident, the node's residual
                # must be computed against the envelope it was admitted
                # with, not the staged re-plan.
            retryable = set(retry_set)

            # Process the run one event at a time — identical admission
            # interleaving to the per-event loop.
            for (t_, _, kind, nid, ji, _) in run_events:
                adm.release(active_nids.index(nid), ji)
                if kind == "done":
                    wasted[ji] += (w_done[ji] - summem[ji]) * dts[ji]
                    area_used += summem[ji] * dts[ji]
                    done_at = max(done_at, t_)
                    finished += 1
                    if frontier is not None:  # dependency-release
                        for c in frontier.release(ji):
                            if release[c] > t_:
                                heapq.heappush(
                                    events, (float(release[c]), next(seq),
                                             "arrive", -1, c, 0))
                            else:
                                queue.append(c)
                else:  # OOM kill
                    wasted[ji] += w_oom[ji] * dts[ji]
                    attempts[ji] += 1
                    retries += 1
                    if ji in retryable:
                        # The lane left its node: its staged re-plan may
                        # now become visible to admission.
                        adm.update_lane(ji, starts[ji], peaks[ji],
                                        need[ji])
                        queue.append(ji)
                    else:
                        unschedulable += 1
                        if frontier is not None:  # descendants blocked
                            d = frontier.doom(ji)
                            doomed += d
                            unschedulable += d
                try_admit(t_)

        def process_leave(t: float, nid: int):
            """Node death: drop the admission row (validity-mask entries
            for the dead node vanish with it; other nodes' cached fits
            stay valid — their residuals are unchanged), evict residents
            in admission order, and account the kill like an OOM whose
            wastage stops at the eviction time."""
            nonlocal evictions, unschedulable, doomed
            nonlocal cap_sum, cap_integral, cap_last
            if nid not in active_nids:
                raise KeyError(
                    f"node_leave: unknown or inactive node {nid} "
                    f"at t={t:g}")
            cap_integral += cap_sum * (t - cap_last)
            cap_last = t
            pos = active_nids.index(nid)
            cap_sum -= float(adm.caps[pos])
            evicted = adm.remove_node(pos)
            active_nids.pop(pos)
            requeue: List[int] = []
            for ji in evicted:
                epoch[ji] += 1      # stale pending done/oom events
                evictions += 1
                e = _elapsed_samples(t, adm.admit_t[ji], dts[ji],
                                     lengths[ji])
                w = span_alloc_sum(peaks[ji:ji + 1], bounds[ji:ji + 1],
                                   np.asarray([e]))[0]
                wasted[ji] += w * dts[ji]
                attempts[ji] += 1   # the RetrySpec attempt budget
                if attempts[ji] >= self.max_attempts:
                    unschedulable += 1
                    if frontier is not None:
                        d = frontier.doom(ji)
                        doomed += d
                        unschedulable += d
                else:
                    requeue.append(ji)
            queue.push_front(requeue)  # evicted jobs go ahead of waiters

        def process_join(t: float, nid: int, fe: FaultEvent):
            nonlocal cap_sum, cap_integral, cap_last, starvation_s
            if nid in active_nids:
                raise ValueError(
                    f"node_join: node {nid} already active at t={t:g}")
            cap_integral += cap_sum * (t - cap_last)
            cap_last = t
            adm.add_node(float(fe.capacity_gb))
            active_nids.append(nid)
            cap_sum += float(fe.capacity_gb)
            if parked:  # unpark; the sweep re-parks misfits
                for ji in parked:
                    starvation_s += t - park_t.pop(ji)
                queue.push_front(parked)
                parked.clear()

        if _obs.enabled:
            # Resolve the engine series once — the registry lookup (lock
            # + dict get) is too costly to repeat on every event batch.
            _s_util = _met.series("cluster.utilization")

        try_admit(0.0)
        guard = 0
        while events:
            # Drain the maximal same-time prefix: events pushed *during*
            # this batch land behind it in (t, seq) order, exactly where
            # the one-at-a-time loop would pop them.
            t = events[0][0]
            batch: List[Tuple[float, int, str, int, object, int]] = []
            while events and events[0][0] == t:
                batch.append(heapq.heappop(events))
            guard += len(batch)
            if guard > 200_000:
                raise RuntimeError("cluster sim did not converge")
            last_t = max(last_t, t)

            # Segment the batch: contiguous runs of done/oom events keep
            # the compacted staging path (freshness-filtered — an earlier
            # leave in this batch may have evicted their lanes), while
            # membership/arrival events process individually so staged
            # state never straddles an eviction.
            i = 0
            while i < len(batch):
                kind_i = batch[i][2]
                if kind_i in ("done", "oom"):
                    run_events = []
                    while i < len(batch) and batch[i][2] in ("done", "oom"):
                        ev = batch[i]
                        if ev[5] == epoch[ev[4]]:
                            run_events.append(ev)
                        i += 1
                    if run_events:
                        process_job_run(run_events)
                elif kind_i == "arrive":
                    ji = batch[i][4]
                    i += 1
                    if frontier is None or not frontier.dead[ji]:
                        queue.append(ji)
                    try_admit(t)
                elif kind_i == "leave":
                    process_leave(t, batch[i][3])
                    i += 1
                    try_admit(t)
                else:  # join
                    process_join(t, batch[i][3], batch[i][4])
                    i += 1
                    try_admit(t)

            if _obs.enabled:
                # Per-event-batch engine series keyed by sim time, fed
                # from the host values the loop already holds.
                _s_util.append(t, area_used / max(
                    cap_integral + cap_sum * (t - cap_last), 1e-9))
                _obs.instant("cluster.event_batch", t=t, n=len(batch))

        for ji in parked:
            starvation_s += last_t - park_t.pop(ji)
        for k, v in adm.stats.items():
            self.stats[k] = self.stats.get(k, 0) + v
        if write_back:
            for i, job in enumerate(jobs):
                job.attempts = int(attempts[i])
                job.wasted_gbs = float(wasted[i])
                if attempts[i] > attempts0[i]:  # plan changed by retries
                    s, p = PackedEnvelopes(starts, peaks, nseg).row(i)
                    job.plan = AllocationPlan(starts=s, peaks=p)

        if have_faults:
            # Piecewise-constant capacity under churn; without faults the
            # pre-churn closed form is kept bit-for-bit.
            end_t = max(done_at, cap_last)
            cap_integral += cap_sum * (end_t - cap_last)
            total_cap_area = max(cap_integral, 1e-9)
        else:
            total_cap_area = float(caps.sum()) * max(done_at, 1e-9)
        return ClusterResult(
            makespan=done_at,
            total_wastage_gbs=float(wasted.sum()),
            retries=retries,
            unschedulable=unschedulable,
            avg_utilization=area_used / total_cap_area,
            placements=placements,
            offset=offset,
            evictions=evictions,
            doomed=doomed,
            starved=B - finished - unschedulable,
            starvation_s=starvation_s,
            finished=finished,
        )
