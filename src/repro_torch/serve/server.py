"""The serving loop: tenants + micro-batcher + caches, one dispatch path.

:class:`PredictionServer` wires the three serve layers together and owns
the only code that actually runs models:

* ``predict`` requests whose snapshot bottoms out in a fitted
  :class:`repro_torch.core.predictor.SegmentModel` (ks+, ks+auto) are
  **gathered across snapshots**: the bucket stacks every lane's
  regression coefficients and evaluates the whole batch on the host, in
  numpy, with the exact elementwise recipe of
  :func:`repro_torch.core.predictor.predict_plans_packed` — per-row ops only,
  offsets cast to the regression dtype — so the batched plans are
  *bit-identical* to per-request calls.  One bucket per
  ``(k, dtype)`` regardless of tenant, family or method: eight tenants'
  ks+ traffic shares one program.
* other ``predict`` requests bucket per snapshot and go through the
  method's own ``predict_packed`` (every registered method has one —
  seeding requires the ``packed`` capability), also on the host.
* ``evaluate`` / ``tune_offset`` bucket per ``(tenant, family, sid)``
  and replay the snapshot's fitted history through
  :func:`repro_torch.core.fleet.simulate_fleet_many` against a
  **device-resident** trace batch cached per snapshot on the server's
  device (``serve.dev_sync`` fires only when it is first built).  On the
  card that is one launch of the hand-written ``fleet_engine`` kernel per
  evaluate dispatch, and one per ``tune_offset`` candidate group (every
  candidate's lanes in the same launch); on the CPU, its plain version.

Lane counts are exact: eager PyTorch compiles nothing per shape, so
nothing is padded.  Warm traffic builds and loads no kernel library —
``tests/test_torch_contracts.py`` pins the serving path under
``dispatch_budget(compiles=0)``.  Every bucket dispatch fires exactly one
``serve.batch`` tag.

:class:`ServeClient` is the synchronous in-process client: ``*_async``
returns a :class:`repro_torch.serve.batcher.ServeFuture`; the plain calls
resolve it by draining the batcher (manual-clock servers) or waiting on
the background thread (:meth:`PredictionServer.start`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.analysis.contracts import record_dispatch
from repro_torch.core import registry
from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.envelope import OffsetCandidate, apply_offsets
from repro_torch.core.fleet import (bucket_traces, packed_predict,
                                    simulate_fleet_many)
from repro_torch.core.predictor import (ExecutionOutcome, MemoryPredictor,
                                        RefitPolicy, SegmentModel)
from repro_torch.obs import metrics as _met
from repro_torch.obs import trace as _obs
from repro_torch.serve.batcher import MicroBatcher, ServeFuture, ServeRequest
from repro_torch.serve.cache import PredictionCache, ProgramCache
from repro_torch.serve.tenants import ModelSnapshot, TenantRegistry

__all__ = ["EvaluateResult", "TuneResult", "PredictionServer", "ServeClient"]


@dataclasses.dataclass(frozen=True)
class EvaluateResult:
    """One ``evaluate`` response: the snapshot replayed on its own
    fitted history through the OOM/retry fleet engine."""

    total_gbs: float     # total wastage (GB*s) over the fitted executions
    n: int               # executions replayed
    succeeded: int       # lanes that finished within max_attempts
    mean_attempts: float
    sid: int             # snapshot that produced this result
    version: int


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One ``tune_offset`` response (see
    :func:`repro_torch.core.registry.tune_offset`)."""

    best: OffsetCandidate
    totals: np.ndarray   # per-candidate training wastage (GB*s)
    sid: int


def _plan_from_rows(starts: np.ndarray, peaks: np.ndarray) -> AllocationPlan:
    """Hot-path :class:`AllocationPlan` construction.

    The scatter loop hands this already-normalized rows (1-D float64,
    pinned/monotone by the batched evaluation), so the dataclass
    ``__post_init__`` re-validation is skipped — at thousands of plans
    per flush it is a measurable share of the serving floor.
    """
    plan = AllocationPlan.__new__(AllocationPlan)
    object.__setattr__(plan, "starts", starts)
    object.__setattr__(plan, "peaks", peaks)
    return plan


def _segment_model(method: MemoryPredictor) -> Optional[SegmentModel]:
    """The fitted SegmentModel a method bottoms out in, or None.

    Unwraps ``.model`` chains (KSPlusAuto -> KSPlus -> SegmentModel);
    anything else (baselines, k-Segments' own regressions) dispatches
    through its ``predict_packed`` instead of the gathered path.
    """
    m = method
    for _ in range(3):
        try:
            m = m.model
        except (AttributeError, RuntimeError):
            return None
        if isinstance(m, SegmentModel):
            return m
    return None


class PredictionServer:
    """Multi-tenant prediction-as-a-service front (in-process).

    ``batching=False`` degrades the SAME machinery to per-request
    dispatch (``max_batch=1``: every submit flushes itself) — the
    unbatched baseline the saturation benchmark and the bitwise tests
    compare against runs the identical dispatch code on 1-lane buckets.

    ``clock`` injects a monotonic float source (virtual clocks in tests
    and the benchmark); :meth:`start` runs the deadline loop on a
    background thread against wall time instead.

    ``device`` is where the tenants' methods fit and their trace batches
    live (None means the card; without CUDA that raises — pass
    ``device="cpu"`` for the plain path).
    """

    def __init__(self, *, machine_memory: float = 128.0,
                 batching: bool = True, max_wait_s: float = 0.002,
                 max_batch: int = 256, max_queue: int = 4096,
                 cache_predictions: bool = True, clock=None,
                 sync_timeout_s: float = 30.0, device=None):
        self.tenants = TenantRegistry(machine_memory=machine_memory,
                                      device=device)
        self.device = self.tenants.device
        self.programs = ProgramCache()
        self.predictions = PredictionCache() if cache_predictions else None
        self.batching = bool(batching)
        self.sync_timeout_s = float(sync_timeout_s)
        self._batcher = MicroBatcher(
            self._dispatch, self._bucket_key,
            max_wait_s=max_wait_s if self.batching else 0.0,
            max_batch=max_batch if self.batching else 1,
            max_queue=max_queue, clock=clock)
        self.clock = self._batcher.clock
        self._threaded = False
        self._seg_lock = threading.Lock()
        self._segmodels: Dict[int, Optional[SegmentModel]] = {}
        # Per-sid hot-path memos (snapshots are immutable, so these are
        # write-once; plain dict reads keep the submit path lock-free).
        self._predict_keys: Dict[int, tuple] = {}
        self._gather_rows: Dict[int, tuple] = {}
        self.tenants.on_refit(self._on_refit)

    # --------------------------------------------------------- lifecycle
    def add_tenant(self, name: str) -> None:
        self.tenants.add_tenant(name)

    def seed_family(self, family: str,
                    method: Union[str, MemoryPredictor],
                    mems: Sequence[np.ndarray], dts: Sequence[float],
                    inputs: Sequence[float], *, k: int = 4,
                    default_limit: float = 8.0,
                    tenants: Optional[Sequence[str]] = None) -> ModelSnapshot:
        """Fit once, share the frozen snapshot across tenants (see
        :meth:`repro_torch.serve.tenants.TenantRegistry.seed`)."""
        return self.tenants.seed(family, method, mems, dts, inputs, k=k,
                                 default_limit=default_limit, tenants=tenants)

    def client(self, tenant: str) -> "ServeClient":
        self.tenants._state(tenant)  # loud on unknown tenant
        return ServeClient(self, tenant)

    def start(self) -> None:
        """Serve on a background thread (wall-clock deadline flushes)."""
        self._threaded = True
        self._batcher.start()

    def stop(self) -> None:
        self._batcher.stop()
        self._threaded = False

    def close(self) -> None:
        """Shut down: stop the pump thread and fail still-queued
        requests with :class:`repro_torch.serve.batcher.ServerClosed` instead
        of letting their callers hang (``stop`` drains; ``close``
        abandons).  Idempotent; later submits are rejected."""
        self._batcher.close()
        self._threaded = False

    def __enter__(self) -> "PredictionServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def threaded(self) -> bool:
        return self._threaded

    # --------------------------------------------------------- submission
    def submit(self, kind: str, tenant: str, family: str,
               payload: Any = None) -> ServeFuture:
        """Queue one request; prediction-cache hits resolve immediately
        (no batch wait, no dispatch — the ``serve.cache_hit`` fast path)."""
        try:  # inlined TenantRegistry.snapshot: two dict hops per request
            snap = self.tenants._tenants[tenant].families[family]
        except KeyError:
            snap = self.tenants.snapshot(tenant, family)  # loud errors
        if kind == "predict" and self.predictions is not None:
            hit = self.predictions.get(snap.sid, payload)
            if hit is not None:
                if _obs.enabled:
                    _met.counter("serve.requests").inc(kind=kind,
                                                       cache="hit")
                fut = ServeFuture()
                fut.set_result(hit)
                return fut
        if _obs.enabled:
            _met.counter("serve.requests").inc(kind=kind, cache="miss")
        req = ServeRequest(kind=kind, tenant=tenant, family=family,
                           payload=payload, arrival=self.clock())
        req.snapshot = snap
        return self._batcher.submit(req)

    def pump(self, now: Optional[float] = None) -> int:
        """Manual-clock driving: flush iff due (see MicroBatcher.pump)."""
        return self._batcher.pump(now)

    def drain(self) -> int:
        """Force-dispatch everything pending; returns requests served."""
        total = 0
        while True:
            n = self._batcher.flush()
            if n == 0:
                return total
            total += n

    @property
    def depth(self) -> int:
        return self._batcher.depth

    def oldest_deadline(self) -> Optional[float]:
        return self._batcher.oldest_deadline()

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "batcher": dict(self._batcher.stats),
            "shapes": self.programs.shape_stats.as_dict(),
            "traces": self.programs.trace_stats.as_dict(),
            "distinct_shapes": self.programs.distinct_shapes,
        }
        if self.predictions is not None:
            out["predictions"] = self.predictions.stats.as_dict()
        return out

    # ------------------------------------------------------ cache plumbing
    def _sid_live(self, sid: int) -> bool:
        """Does any tenant still serve from snapshot ``sid``?"""
        for st in self.tenants._tenants.values():
            for snap in st.families.values():
                if snap.sid == sid:
                    return True
        return False

    def _on_refit(self, tenant: str, family: str, old: ModelSnapshot,
                  new: ModelSnapshot) -> None:
        # Refit-scoped invalidation.  The forked tenant's lookups move to
        # the new sid by construction; the old sid's entries stay valid
        # for any tenant still sharing that snapshot and are dropped only
        # once the last reference is gone.
        self.programs.invalidate_tenant_family(tenant, family)
        if not self._sid_live(old.sid):
            if self.predictions is not None:
                self.predictions.invalidate_sid(old.sid)
            with self._seg_lock:
                self._segmodels.pop(old.sid, None)
            self._predict_keys.pop(old.sid, None)
            self._gather_rows.pop(old.sid, None)

    def _segmodel(self, snap: ModelSnapshot) -> Optional[SegmentModel]:
        with self._seg_lock:
            if snap.sid not in self._segmodels:
                self._segmodels[snap.sid] = _segment_model(snap.method)
            return self._segmodels[snap.sid]

    # ---------------------------------------------------------- bucketing
    def _bucket_key(self, req: ServeRequest):
        snap = req.snapshot
        if req.kind == "predict":
            key = self._predict_keys.get(snap.sid)
            if key is None:
                seg = self._segmodel(snap)
                if seg is not None:
                    # Cross-snapshot gather: one program per (k, dtype).
                    key = ("predict-gather",
                           int(seg.start_reg.slope.shape[0]),
                           str(seg.start_reg.slope.dtype))
                else:
                    key = ("predict-packed", snap.sid)
                self._predict_keys[snap.sid] = key
            return key
        if req.kind in ("evaluate", "tune_offset"):
            return (req.kind, req.tenant, req.family, snap.sid)
        raise ValueError(f"unknown request kind: {req.kind!r}")

    # ----------------------------------------------------------- dispatch
    def _dispatch(self, key, reqs: List[ServeRequest]) -> None:
        record_dispatch("serve.batch")  # exactly one per bucket flush
        if key[0] == "predict-gather":
            self._predict_gathered(key, reqs)
        elif key[0] == "predict-packed":
            self._predict_packed(reqs)
        elif key[0] == "evaluate":
            self._evaluate(reqs)
        else:
            self._tune(reqs)

    def _scatter_plans(self, reqs, starts, peaks) -> None:
        # One vectorized cast to the plans' float64 — exact on float32
        # inputs, and per-row AllocationPlan construction then aliases
        # the rows instead of re-converting lane by lane.
        starts = np.asarray(starts, np.float64)
        peaks = np.asarray(peaks, np.float64)
        put = None if self.predictions is None else self.predictions.put
        for i, r in enumerate(reqs):
            plan = _plan_from_rows(starts[i], peaks[i])
            if put is not None:
                put(r.snapshot.sid, r.payload, plan)
            r.future.set_result(plan)

    def _rows_of(self, snap: ModelSnapshot) -> tuple:
        """Write-once per-sid gather rows: the SegmentModel's regression
        coefficients plus its offset factors as python floats (cast to
        the slope dtype at stack time — NumPy's weak-scalar promotion)."""
        rows = self._gather_rows.get(snap.sid)
        if rows is None:
            s = self._segmodel(snap)
            rows = (s.start_reg.slope, s.start_reg.intercept,
                    s.peak_reg.slope, s.peak_reg.intercept,
                    1.0 - s.start_offset, 1.0 + s.peak_offset)
            self._gather_rows[snap.sid] = rows
        return rows

    def _predict_gathered(self, key, reqs: List[ServeRequest]) -> None:
        """Batched SegmentModel evaluation across snapshots.

        Replicates :func:`repro_torch.core.predictor.predict_plans_packed` with
        per-lane coefficient rows.  Precision contract: every op is
        elementwise per lane and the offset columns are cast to the slope
        dtype (matching NumPy's weak-scalar promotion in the per-model
        path), so results are bit-identical to single-request dispatch.
        """
        _, k, dtype_name = key
        dtype = np.dtype(dtype_name)
        B = len(reqs)
        # Lanes usually repeat a handful of snapshots (shared seeds), so
        # stack each distinct sid's coefficients once and fan them out to
        # lanes with one fancy index — bitwise the same rows, without a
        # per-lane np.stack loop.
        sid_slot: Dict[int, int] = {}
        uniq: List[tuple] = []
        lanes = np.empty(B, np.intp)
        for i, r in enumerate(reqs):
            sid = r.snapshot.sid
            slot = sid_slot.get(sid)
            if slot is None:
                slot = sid_slot[sid] = len(uniq)
                uniq.append(self._rows_of(r.snapshot))
            lanes[i] = slot
        I = np.asarray([r.payload for r in reqs], dtype)
        ss = np.stack([g[0] for g in uniq])[lanes]
        si = np.stack([g[1] for g in uniq])[lanes]
        ps = np.stack([g[2] for g in uniq])[lanes]
        pi = np.stack([g[3] for g in uniq])[lanes]
        so = np.asarray([g[4] for g in uniq], dtype)[lanes]
        po = np.asarray([g[5] for g in uniq], dtype)[lanes]
        self.programs.note_shape("segment-gather", None, k, None, ss.shape)
        Ic = I[:, None]
        starts = (ss * Ic + si) * so[:, None]
        peaks = (ps * Ic + pi) * po[:, None]
        starts = np.maximum.accumulate(np.maximum(starts, 0.0), axis=1)
        starts[:, 0] = 0.0
        peaks = np.maximum.accumulate(np.maximum(peaks, 1e-6), axis=1)
        self._scatter_plans(reqs, starts, peaks)

    def _predict_packed(self, reqs: List[ServeRequest]) -> None:
        """One snapshot's bucket through its own ``predict_packed``.

        Snapshot-shared seeds make this batch across tenants too: every
        tenant still on the seed snapshot lands in the same bucket.
        """
        snap = reqs[0].snapshot
        inputs = np.asarray([float(r.payload) for r in reqs], np.float64)
        starts, peaks = snap.method.predict_packed(inputs)
        self.programs.note_shape(snap.method_name, snap.family,
                                 starts.shape[1], None, starts.shape)
        self._scatter_plans(reqs, starts, peaks)

    def _trace_batch(self, tenant: str, family: str, snap: ModelSnapshot):
        return self.programs.trace_batch(
            tenant, family, snap.sid,
            lambda: bucket_traces([np.asarray(m) for m in snap.train_mems],
                                  device=self.device))

    def _evaluate(self, reqs: List[ServeRequest]) -> None:
        """Replay the snapshot's fitted history through the fleet engine.

        All requests in the bucket share one snapshot, so the result is
        computed once and fanned out: one ``fleet_engine`` launch on the
        card.  Feeding the cached device-resident batch to
        ``simulate_fleet_many`` is bitwise-equal to passing the raw traces
        (its ``_as_batch`` builds the identical ``bucket_traces``
        grouping).
        """
        r0 = reqs[0]
        snap = r0.snapshot
        batch = self._trace_batch(r0.tenant, r0.family, snap)
        starts, peaks, nseg = packed_predict(snap.method,
                                             list(snap.train_inputs))
        self.programs.note_shape(snap.method_name, snap.family,
                                 starts.shape[1], snap.dt,
                                 tuple(b.dmems.shape for b in batch.buckets))
        res = simulate_fleet_many(
            [((starts, peaks, nseg), snap.method.retry_spec)], batch,
            snap.dt, machine_memory=snap.machine_memory)[0]
        out = EvaluateResult(
            total_gbs=float(res.total_gbs), n=len(snap.train_mems),
            succeeded=int(res.succeeded.sum()),
            mean_attempts=float(res.attempts.mean()),
            sid=snap.sid, version=snap.version)
        for r in reqs:
            r.future.set_result(out)

    def _tune(self, reqs: List[ServeRequest]) -> None:
        """Offset auto-tuning on the snapshot's history — the body of
        :func:`repro_torch.core.registry.tune_offset`, fed the cached device
        batch (bitwise-equal: same traces, same grouping).  One
        ``simulate_fleet_many`` call per candidate group: every
        candidate's lanes go out in one ``fleet_engine`` launch."""
        r0 = reqs[0]
        snap = r0.snapshot
        method = snap.method
        batch = self._trace_batch(r0.tenant, r0.family, snap)
        groups: Dict[Any, List[ServeRequest]] = {}
        for r in reqs:  # payload = candidates (None -> the default grid)
            cands = tuple(r.payload) if r.payload is not None \
                else registry.DEFAULT_OFFSET_GRID
            groups.setdefault(cands, []).append(r)
        for cands, group in groups.items():
            if not cands:
                raise ValueError("need at least one OffsetCandidate")
            starts, peaks, nseg = packed_predict(method,
                                                 list(snap.train_inputs))
            jobs = []
            for cand in cands:
                st, pk = apply_offsets(starts, peaks, nseg, cand)
                spec = method.retry_spec
                if cand.last_peak_bump is not None:
                    spec = spec._replace(bump=cand.last_peak_bump)
                jobs.append(((st.astype(np.float32), pk.astype(np.float32),
                              nseg), spec))
            self.programs.note_shape(snap.method_name, snap.family,
                                     starts.shape[1], snap.dt,
                                     tuple(b.dmems.shape
                                           for b in batch.buckets))
            results = simulate_fleet_many(jobs, batch, snap.dt,
                                          machine_memory=snap.machine_memory)
            totals = np.asarray([r.total_gbs for r in results])
            out = TuneResult(best=cands[int(np.argmin(totals))],
                             totals=totals, sid=snap.sid)
            for r in group:
                r.future.set_result(out)


class ServeClient:
    """Synchronous in-process client bound to one tenant.

    ``*_async`` methods return futures (manual pumping / threaded
    servers); the plain methods block — by draining the server when it
    has no background thread, by waiting on the future otherwise.
    ``observe`` / ``refit`` are tenant-local state writes and run inline.
    """

    def __init__(self, server: PredictionServer, tenant: str):
        self._server = server
        self.tenant = tenant

    # ----------------------------------------------------------- requests
    def predict_async(self, family: str, input_gb: float) -> ServeFuture:
        return self._server.submit("predict", self.tenant, family,
                                   float(input_gb))

    def predict(self, family: str, input_gb: float) -> AllocationPlan:
        return self._sync(self.predict_async(family, input_gb))

    def evaluate_async(self, family: str) -> ServeFuture:
        return self._server.submit("evaluate", self.tenant, family)

    def evaluate(self, family: str) -> EvaluateResult:
        return self._sync(self.evaluate_async(family))

    def tune_offset_async(
            self, family: str,
            candidates: Optional[Sequence[OffsetCandidate]] = None
    ) -> ServeFuture:
        return self._server.submit("tune_offset", self.tenant, family,
                                   tuple(candidates) if candidates else None)

    def tune_offset(self, family: str,
                    candidates: Optional[Sequence[OffsetCandidate]] = None
                    ) -> TuneResult:
        return self._sync(self.tune_offset_async(family, candidates))

    # -------------------------------------------------------------- state
    def observe(self, family: str, outcome: ExecutionOutcome) -> int:
        return self._server.tenants.observe(self.tenant, family, outcome)

    def refit(self, family: str,
              policy: Union[RefitPolicy, str] = "every_1") -> bool:
        return self._server.tenants.refit(self.tenant, family, policy)

    def snapshot(self, family: str) -> ModelSnapshot:
        return self._server.tenants.snapshot(self.tenant, family)

    # ------------------------------------------------------------ plumbing
    def _sync(self, fut: ServeFuture):
        if not fut.done:
            if self._server.threaded:
                return fut.result(self._server.sync_timeout_s)
            self._server.drain()
        return fut.result(self._server.sync_timeout_s)
