"""Elastic scaling: node membership changes + mesh re-planning.

At 1000+-node scale, membership churn is routine.  This module keeps the
data plane restartable under churn:

* :func:`plan_mesh` — best (data, model) factorization for a surviving
  device count, honoring divisibility of the model's sharded dims.
* :class:`ElasticPlanner` — admission control for concurrent jobs using
  their KS+ memory envelopes (host- or device-side).  It shares *runtime
  state* with :class:`repro_torch.sched.cluster.ClusterSim`'s fused
  engine, not just the primitive: every decision — ``admit``, ``submit``,
  and the churn-driven ``drain`` — reads the same
  :class:`repro_torch.sched.admission.AdmissionState` fits matrix under the
  same invalidation protocol (time advance, place, release, plan change, node
  join/leave).  Admission is the pointwise fits-under-residual check over
  the slice's packed resident envelopes — a multi-segment envelope can be
  admitted into head-room that only exists *over time* — with the slice
  residual evaluated conservatively (resident envelopes count forever:
  ``usage_over`` with ``dur=None``), and ties broken toward the slice with
  the most post-placement head-room, matching the historical behavior for
  flat envelopes.  ``node_leave`` evicts the victim slice's jobs into a
  checkpoint/requeue list, ``node_join`` (and
  :meth:`ElasticPlanner.drain`) re-admits queued jobs through the same
  fits columns.

Together with the deterministic data pipeline (batches are a pure function
of ``(seed, step, shard)``) and atomic checkpoints, a re-shard is: drain →
checkpoint → re-plan mesh → restore → continue at the same step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import AllocationPlan
from repro_torch.core.envelope import (
    PAD_START,
    PackedEnvelopes,
    alloc_at_packed,
    usage_over,
)
from repro_torch.sched.admission import AdmissionState

__all__ = ["plan_mesh", "ElasticPlanner"]


def plan_mesh(n_devices: int, model_divisors: Tuple[int, ...],
              prefer_model: int = 16) -> Tuple[int, int]:
    """Pick (data, model) for ``n_devices`` so every dim in
    ``model_divisors`` stays divisible by the model axis."""
    best = (n_devices, 1)
    for model in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % model:
            continue
        if all(d % model == 0 for d in model_divisors if d):
            best = (n_devices // model, model)
            break
    return best


HORIZON_S = 600.0
HORIZON_GRID = 32


@dataclasses.dataclass
class _Slice:
    """Public per-slice view (resident jobs, introspection helpers).

    Admission *decisions* do not run through this object — they read the
    planner's shared :class:`AdmissionState` fits matrix; ``headroom`` is
    kept as a standalone float64 view for monitoring/inspection (on the
    same default horizon grid the admission state uses).
    """

    name: str
    memory_gb: float
    jobs: List[Tuple[str, AllocationPlan, float]] = dataclasses.field(
        default_factory=list)  # (job id, envelope, started_at)

    def headroom(self, now: float, horizon_s: float = HORIZON_S) -> float:
        """Worst-case free memory over the horizon — packed evaluation of
        every resident envelope at once."""
        if not self.jobs:
            return float(self.memory_gb)
        grid = now + np.linspace(0, horizon_s, HORIZON_GRID)
        env = PackedEnvelopes.from_plans([p for _, p, _ in self.jobs])
        t0 = np.asarray([t for _, _, t in self.jobs], np.float64)
        used = usage_over(env.starts, env.peaks, t0, grid)
        return float(self.memory_gb - used.max())


class ElasticPlanner:
    """Envelope-aware admission control under node churn.

    Jobs that cannot be placed (yet) wait in ``pending`` in submission
    order; every membership change re-runs the shared fits-matrix check
    over the queue.  ``node_leave`` returns the job ids that must
    checkpoint — they are simultaneously requeued, so the next
    ``node_join``/``drain`` re-admits them automatically (the re-shard
    decision is: evicted job → checkpoint → requeue → restore wherever it
    fits next).

    ``backend="numpy"`` (default) runs the shared admission state on the
    float64 host path; ``backend="fused"`` runs the same protocol as
    float64 device programs on ``device`` (None means the card; identical
    decisions — see the precision contract in
    :mod:`repro_torch.sched.admission`).
    """

    def __init__(self, backend: str = "numpy",
                 shard: Optional[int] = None, device=None):
        self.slices: Dict[str, _Slice] = {}
        self.pending: List[Tuple[str, AllocationPlan]] = []
        self._adm = AdmissionState(
            [], K=1, G=HORIZON_GRID, backend=backend, use_dur=False,
            shard=shard, device=device)
        self._names: List[str] = []  # slice name per AdmissionState row
        self._grid = np.linspace(0.0, HORIZON_S, HORIZON_GRID)
        self._lane: Dict[str, int] = {}  # job id -> lane index
        self._free: List[int] = []       # recycled lanes of finished jobs

    # ------------------------------------------------------------ membership
    def node_join(self, name: str, memory_gb: float,
                  now: Optional[float] = None) -> Dict[str, str]:
        """Add a slice and (with ``now`` given) re-admit queued jobs onto
        the grown pool.

        ``now`` must be the *current* scheduler time — resident envelopes
        are evaluated relative to it, so draining at a stale time would
        overestimate headroom.  Without ``now`` the queue is left for an
        explicit :meth:`drain`.  Returns ``{job id: slice name}`` for every
        queued job placed by this join.
        """
        self.slices[name] = _Slice(name, memory_gb)
        self._adm.add_node(memory_gb)
        self._names.append(name)
        return self.drain(now) if now is not None else {}

    def node_leave(self, name: str, now: Optional[float] = None) -> List[str]:
        """Remove a slice; returns job ids that must be checkpointed.

        The evicted jobs are requeued (ahead of other waiters — they hold
        checkpoints and were running first); with ``now`` given they are
        immediately re-admitted wherever they fit on the surviving slices.

        Raises :class:`KeyError` naming the slice when ``name`` is not a
        current member — a silent no-op here would let a fleet-state
        mismatch (double leave, typoed name) go unnoticed while the
        planner keeps admitting against stale capacity.  The ClusterSim
        fault path applies the same check to ``leave`` events.
        """
        if name not in self.slices:
            raise KeyError(f"node_leave: unknown slice {name!r}")
        sl = self.slices.pop(name)
        self._adm.remove_node(self._names.index(name))
        self._names.remove(name)
        evicted = [(jid, plan) for jid, plan, _ in sl.jobs]
        self.pending = evicted + self.pending
        if now is not None:
            self.drain(now)
        return [jid for jid, _ in evicted]

    # ------------------------------------------------------------- admission
    @staticmethod
    def _as_plan(envelope, input_gb=None) -> AllocationPlan:
        """Normalize the admission argument into an allocation envelope.

        Accepts an :class:`AllocationPlan`, a fitted method instance, or a
        registered method *name* (:mod:`repro_torch.core.registry` — names
        construct fresh instances, so they only work for fit-free methods
        like ``"default"``); methods predict with ``input_gb``.
        """
        if isinstance(envelope, AllocationPlan):
            return envelope
        from repro_torch.core import registry
        method = registry.resolve(envelope)
        if input_gb is None:
            raise ValueError(
                "admitting via a method (or registry name) needs input_gb")
        return method.predict(float(input_gb))

    def _ensure_lane(self, jid: str, envelope: AllocationPlan) -> int:
        """Lane index for ``jid`` in the shared state (created on first
        sight; resubmission with a changed envelope re-plans the lane)."""
        n = len(envelope.starts)
        self._adm.ensure_k(n)
        K = self._adm.K
        starts = np.full((K,), PAD_START, np.float64)
        peaks = np.empty((K,), np.float64)
        starts[:n] = envelope.starts
        peaks[:n] = envelope.peaks
        peaks[n:] = envelope.peaks[-1]
        need = alloc_at_packed(starts[None], peaks[None], self._grid)[0]
        lane = self._lane.get(jid)
        if lane is None:
            if self._free:  # recycle a finished job's lane: state stays
                lane = self._free.pop()  # bounded by max *concurrent* jobs
                self._adm.update_lane(lane, starts, peaks, need)
            else:
                lane = int(self._adm.add_lanes(
                    starts[None], peaks[None], need[None],
                    self._grid[None])[0])
            self._lane[jid] = lane
        elif not (np.array_equal(self._adm.starts[lane], starts)
                  and np.array_equal(self._adm.peaks[lane], peaks)):
            self._adm.update_lane(lane, starts, peaks, need)
        return lane

    def admit(self, jid: str, envelope, now: float, *,
              input_gb: Optional[float] = None) -> Optional[str]:
        """Place a job via the shared fits matrix.

        ``envelope`` is an :class:`AllocationPlan`, a fitted method, or a
        registered method name (see :meth:`_as_plan`).  Among the slices
        whose residual envelope covers the job's need pointwise over the
        horizon, pick the one with the most post-placement head-room
        (``minresid - peak``, first on ties — identical to the historical
        scalar rule for flat envelopes).
        """
        envelope = self._as_plan(envelope, input_gb)
        if not self._names:
            return None
        lane = self._ensure_lane(jid, envelope)
        for ni, name in enumerate(self._names):
            if lane in self._adm.running[ni]:
                # Already resident: this was a live re-size (the lane's
                # reservation just changed in place), not a placement.
                sl = self.slices[name]
                sl.jobs = [(j, envelope if j == jid else p, t)
                           for j, p, t in sl.jobs]
                return name
        col = self._adm.columns(now, [lane])[:, 0]  # (N,) fits
        if not col.any():
            return None
        head = self._adm.minresid[:, lane] - float(envelope.peaks.max())
        ni = int(np.argmax(np.where(col, head, -np.inf)))
        self._adm.place(ni, lane, now)
        name = self._names[ni]
        self.slices[name].jobs.append((jid, envelope, now))
        return name

    def submit(self, jid: str, envelope, now: float, *,
               input_gb: Optional[float] = None) -> Optional[str]:
        """Admit now, or queue for the next membership change."""
        envelope = self._as_plan(envelope, input_gb)
        placed = self.admit(jid, envelope, now)
        if placed is None:
            self.pending.append((jid, envelope))
        return placed

    def drain(self, now: float) -> Dict[str, str]:
        """Re-run admission for every queued job, in queue order — each
        decision reads the shared fits matrix, refreshed only where the
        invalidation protocol says it is stale.

        On ``backend="fused"`` the whole queue drains in one device drain
        program (:meth:`AdmissionState.drain` with the head-room node
        rule) — decision-identical to the per-job loop because
        placements only shrink residuals, so a job unfit at its queue
        position can never become fit later in the same drain.  Queues
        with duplicate job ids or resident (live re-size) resubmissions
        fall back to the per-job loop, whose ``admit`` handles those
        branches.
        """
        if self._adm.backend == "fused" and self._names and self.pending:
            jids = [j for j, _ in self.pending]
            resident = set()
            for lanes in self._adm.running:
                resident.update(lanes)
            if (len(set(jids)) == len(jids)
                    and all(j in self._lane
                            and self._lane[j] not in resident
                            for j in jids)):
                return self._drain_device(now)
        lanes = [self._lane[j] for j, _ in self.pending if j in self._lane]
        if lanes and self._names:
            # One batched refresh for the whole queue up front; the per-job
            # admissions below then only pay incremental invalidations.
            self._adm.columns(now, lanes)
        placed: Dict[str, str] = {}
        still: List[Tuple[str, AllocationPlan]] = []
        for jid, envelope in self.pending:
            name = self.admit(jid, envelope, now)
            if name is None:
                still.append((jid, envelope))
            else:
                placed[jid] = name
        self.pending = still
        return placed

    def _drain_device(self, now: float) -> Dict[str, str]:
        """Queue-order device drain: re-plan any changed envelopes (lane
        updates are queue-local, so order cannot matter), then place the
        whole queue in one drain program and mirror the decisions into the
        slice rosters."""
        order: List[Tuple[str, AllocationPlan, int]] = []
        for jid, envelope in self.pending:
            self._ensure_lane(jid, envelope)
            order.append((jid, envelope, self._lane[jid]))
        got = dict(self._adm.drain(now, [ln for _, _, ln in order],
                                   select="headroom"))
        placed: Dict[str, str] = {}
        still: List[Tuple[str, AllocationPlan]] = []
        for jid, envelope, lane in order:
            ni = got.get(lane)
            if ni is None:
                still.append((jid, envelope))
            else:
                name = self._names[ni]
                self.slices[name].jobs.append((jid, envelope, now))
                placed[jid] = name
        self.pending = still
        return placed

    @property
    def queued(self) -> List[str]:
        return [jid for jid, _ in self.pending]

    def finish(self, jid: str):
        lane = self._lane.pop(jid, None)
        for ni, name in enumerate(self._names):
            sl = self.slices[name]
            if any(j == jid for j, _, _ in sl.jobs):
                sl.jobs = [(j, p, t) for j, p, t in sl.jobs if j != jid]
                self._adm.release(ni, lane)
        self.pending = [(j, p) for j, p in self.pending if j != jid]
        if lane is not None:
            self._free.append(lane)
