"""Shared admission runtime state: one fits matrix, one invalidation protocol.

Both admission paths — :class:`repro_torch.sched.cluster.ClusterSim`'s
packed event loop and :class:`repro_torch.sched.elastic.ElasticPlanner`'s
churn-driven ``drain`` — answer the same question at every decision point:
*which queued envelopes fit under which node's residual envelope right
now?*  This module owns that answer as explicit runtime state instead of a
per-call recomputation:

* a **fits matrix** ``(N nodes, B lanes)`` of admission predicates plus a
  per-entry **validity mask** — the single source of truth for "does lane b
  fit node n at the current time",
* one **invalidation protocol** (see :class:`AdmissionState`):

  - advancing ``now`` invalidates everything (residuals are functions of
    absolute time),
  - *placing* a lane on a node invalidates only the node's currently-True
    entries — adding an envelope can only shrink the residual, so False
    entries stay False without recomputation (monotonicity),
  - *releasing* a lane from a node invalidates the node's whole column
    (the residual grew; False entries may flip True),
  - a lane's plan change (retry re-plan) invalidates that lane everywhere,
  - node join/leave adds/drops a row,

* two interchangeable compute backends:

  - ``backend="numpy"`` — the float64 host reference: per-node
    :func:`repro_torch.core.envelope.fits_column` calls, exactly the
    arithmetic the packed ``ClusterSim`` engine inlines,
  - ``backend="fused"`` — float64 PyTorch on a device (None means the
    card): one batch of tensor operations per refresh computes every
    invalid ``(node, lane)`` entry at once, and a whole greedy drain runs
    as a loop of device steps over resident state (:meth:`drain`).  The
    packed envelope / need / grid / placement-time buffers live on the
    device and are updated in place (``index_copy_``), so the per-event
    hot path is device work over the already-packed ``(B, K)`` layout —
    not a Python loop over nodes and queued jobs.

Precision contract: both backends evaluate residuals and admission
predicates in float64 with identical elementwise operations — every tensor
of the fused programs is float64, and the Python scalars they meet (the
``1e-9`` window) are applied as float64 operations; the only permitted
divergence is the summation order over a node's resident envelopes (numpy
reduces linearly, a device reduction need not), plus the drain's in-place
residual update, i.e. last-ulp differences ~1e-16 relative.  A decision can
therefore only differ between backends when a lane's need grazes the
residual within one float64 ulp of the 1e-9 admission tolerance — orders
of magnitude below any real trace/plan margin.

Shapes are exact: eager PyTorch compiles nothing per shape, so no axis is
padded to a bucket.

The state is *frontier-agnostic*: ``ClusterSim``'s DAG-aware replay adds
every lane up front but only passes *released* lanes (all parents
finished) to :meth:`AdmissionState.columns` / :meth:`drain`, so dependency
structure costs nothing here — unreleased lanes simply never enter a
refresh.

The join/leave row protocol (:meth:`AdmissionState.add_node` /
:meth:`remove_node`) is what both churn consumers share:
``ElasticPlanner`` drives it for slice membership, and ``ClusterSim``'s
fault path drives it for ``FaultSchedule`` leave/join events —
``remove_node`` returns the dead node's resident lanes *in admission
order*, which is the eviction order every engine pins bitwise.  Node rows
are positional (a leave splices, a join appends); callers keep their own
stable-id ↔ row mapping.  Because the fused programs take ``caps`` and
the resident-lane index per call, churn needs no device-state rebuild.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import record_dispatch
from repro_torch.core.envelope import PAD_START, fits_column
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as _met
from repro_torch.obs import trace as _obs

__all__ = ["AdmissionState"]

WINDOW = 1e-9  # a resident counts inside [t0, t0 + dur + WINDOW)


def _alloc_chain(rs: torch.Tensor, rp: torch.Tensor,
                 relc: torch.Tensor) -> torch.Tensor:
    """Step-function evaluation as a K-step select chain: with ascending
    starts, the last satisfied ``starts_k <= t`` wins — exactly
    ``searchsorted(side='right') - 1`` clipped to ``[0, K-1]``, without a
    ``(lanes, times, K)`` one-hot tensor.  ``(L, K) x (L, M) -> (L, M)``."""
    alloc = rp[:, 0:1].expand(relc.shape)
    for k in range(1, rs.shape[1]):
        alloc = torch.where(rs[:, k:k + 1] <= relc, rp[:, k:k + 1], alloc)
    return alloc


def _residual(starts, peaks, admit_t, dur, caps, run_idx, run_valid, tabs,
              masked: bool) -> torch.Tensor:
    """``resid[n, m] = caps[n] - sum_r alloc_r(tabs[m] - t0[r])`` over each
    node's residents (``run_idx`` ``(N, R)``, padded rows masked out by
    ``run_valid``), mirroring ``residual_over`` elementwise in float64.
    ``masked`` selects the anticipating residual (a resident only counts
    inside ``[t0, t0 + dur)``, the cluster's rule) over the conservative
    count-forever one (the elastic planner's)."""
    N, R = run_idx.shape
    flat = run_idx.reshape(-1)
    rel = tabs[None, :] - admit_t[flat][:, None]        # (N*R, M)
    alloc = _alloc_chain(starts[flat], peaks[flat], rel.clamp_min(0.0))
    if masked:
        active = (rel >= 0.0) & (rel < dur[flat][:, None] + WINDOW)
        alloc = torch.where(active, alloc, 0.0)
    alloc = torch.where(run_valid.reshape(-1)[:, None], alloc, 0.0)
    return caps[:, None] - alloc.reshape(N, R, -1).sum(dim=1)


class AdmissionState:
    """Fits matrix + invalidation protocol over packed ``(B, K)`` envelopes.

    Lanes (queued/resident jobs) carry a packed envelope, a relative
    admission grid with its precomputed ``need`` evaluation, a placement
    time and an active-window duration; nodes carry a capacity and the
    list of resident lanes.  ``columns()`` refreshes every invalid
    ``(node, lane)`` entry for the requested lanes — one batch of device
    operations and one host read on the fused backend — and returns the
    fits matrix slice; ``place`` / ``release`` / ``update_lane`` /
    ``add_node`` / ``remove_node`` keep the validity mask honest.

    ``use_dur=False`` selects the elastic planner's conservative
    count-forever residual (``usage_over`` with ``dur=None``).  The fused
    backend runs on ``device`` (None means the card); ``shard`` (a drain
    whose node axis is split over several devices) is not ported yet and
    raises for more than one device.

    :attr:`stats` counts ``drains``, the fused drain programs run
    (``drain_dispatches``), their loop iterations (``drain_iterations``)
    and the device-to-host reads of the fused backend (``host_reads``:
    one per drain iteration, one per fused refresh).
    """

    # Max candidate lanes per drain program.  Deep backlogs routinely have
    # hundreds of lanes that *fit somewhere* while capacity admits only a
    # few — capping the program keeps its queue axis small; the exact
    # continuation loop in :meth:`drain` runs the program again in the rare
    # case more than DRAIN_CAP lanes were simultaneously placeable.  Queues
    # at or below the cap skip the candidate pre-filter and go straight
    # into the program: no refresh round-trip.
    DRAIN_CAP = 256

    def __init__(self, caps: Sequence[float], K: int, G: int,
                 backend: str = "fused", use_dur: bool = True,
                 tol: float = 1e-9, shard: Optional[int] = None,
                 device=None):
        if backend not in ("fused", "numpy"):
            raise ValueError(f"unknown admission backend: {backend!r}")
        if shard is not None:
            if backend != "fused":
                raise ValueError("shard= requires backend='fused'")
            shard = int(shard)
            if shard < 1:
                raise ValueError(f"shard must be >= 1, got {shard}")
            if shard > 1:
                raise NotImplementedError(
                    "a drain sharded over several devices is not ported "
                    "yet; use shard=None")
        self.shard = shard
        self.device = resolve_device(device) if backend == "fused" else None
        self.stats = {"drains": 0, "drain_dispatches": 0,
                      "drain_iterations": 0, "host_reads": 0}
        self.backend = backend
        self.use_dur = bool(use_dur)
        self.tol = float(tol)
        self.K = int(K)
        self.G = int(G)
        self.caps = np.asarray(caps, np.float64).copy()
        N = len(self.caps)
        self.running: List[List[int]] = [[] for _ in range(N)]
        # Lane state (grows via add_lanes).
        self.starts = np.zeros((0, self.K), np.float64)
        self.peaks = np.zeros((0, self.K), np.float64)
        self.need = np.zeros((0, self.G), np.float64)
        self.grid = np.zeros((0, self.G), np.float64)
        self.admit_t = np.zeros((0,), np.float64)
        self.dur = np.zeros((0,), np.float64)
        # The shared runtime state: fits matrix + validity mask.
        self.fits = np.zeros((N, 0), bool)
        self.minresid = np.zeros((N, 0), np.float64)
        self.valid = np.zeros((N, 0), bool)
        self._now: Optional[float] = None
        self._dirty_dev = True  # device mirrors need a (re)upload

    # ------------------------------------------------------------- lane mgmt
    @property
    def B(self) -> int:
        return int(self.starts.shape[0])

    @property
    def N(self) -> int:
        return int(self.caps.shape[0])

    def ensure_k(self, k: int):
        """Grow the packed segment axis (rare: a new lane with more
        segments than any seen).  Padding follows the PackedEnvelopes
        convention — sentinel starts, replicated last peak — so existing
        lanes evaluate identically."""
        if k <= self.K:
            return
        pad = k - self.K
        B = self.B
        self.starts = np.concatenate(
            [self.starts, np.full((B, pad), PAD_START)], axis=1)
        last = (self.peaks[:, -1:] if self.K else np.zeros((B, 1)))
        self.peaks = np.concatenate(
            [self.peaks, np.repeat(last, pad, axis=1)], axis=1)
        self.K = k
        self._dirty_dev = True

    def add_lanes(self, starts, peaks, need, grid,
                  dur=None) -> np.ndarray:
        """Append lanes; returns their indices.  New entries are invalid."""
        starts = np.asarray(starts, np.float64).reshape(-1, self.K)
        n = starts.shape[0]
        self.starts = np.concatenate([self.starts, starts])
        self.peaks = np.concatenate(
            [self.peaks, np.asarray(peaks, np.float64).reshape(n, self.K)])
        self.need = np.concatenate(
            [self.need, np.asarray(need, np.float64).reshape(n, self.G)])
        self.grid = np.concatenate(
            [self.grid, np.asarray(grid, np.float64).reshape(n, self.G)])
        self.admit_t = np.concatenate([self.admit_t, np.zeros(n)])
        self.dur = np.concatenate(
            [self.dur,
             np.full(n, np.inf) if dur is None
             else np.asarray(dur, np.float64).reshape(n)])
        pad = np.zeros((self.N, n), bool)
        self.fits = np.concatenate([self.fits, pad], axis=1)
        self.valid = np.concatenate([self.valid, pad.copy()], axis=1)
        self.minresid = np.concatenate(
            [self.minresid, np.zeros((self.N, n))], axis=1)
        self._dirty_dev = True
        return np.arange(self.B - n, self.B)

    def update_lane(self, lane: int, starts, peaks, need):
        """Re-plan a lane; its column is invalid on every node.

        If the lane is currently *resident* somewhere (a live re-size
        rather than a queued retry), that node's residual changed for
        every queued lane — its whole row is invalidated too.
        """
        self.starts[lane] = starts
        self.peaks[lane] = peaks
        self.need[lane] = need
        self.valid[:, lane] = False
        for ni, run in enumerate(self.running):
            if lane in run:
                self.valid[ni] = False
        self._push_lanes(np.asarray([lane]))

    # ------------------------------------------------------------- node mgmt
    def add_node(self, cap: float) -> int:
        self.caps = np.concatenate([self.caps, [float(cap)]])
        self.running.append([])
        B = self.B
        self.fits = np.concatenate([self.fits, np.zeros((1, B), bool)])
        self.valid = np.concatenate([self.valid, np.zeros((1, B), bool)])
        self.minresid = np.concatenate([self.minresid, np.zeros((1, B))])
        return self.N - 1

    def remove_node(self, ni: int) -> List[int]:
        """Drop a node row; returns the lanes that were resident on it."""
        evicted = self.running[ni]
        self.caps = np.delete(self.caps, ni)
        del self.running[ni]
        self.fits = np.delete(self.fits, ni, axis=0)
        self.valid = np.delete(self.valid, ni, axis=0)
        self.minresid = np.delete(self.minresid, ni, axis=0)
        return evicted

    # ----------------------------------------------------------- invalidation
    def sync_now(self, now: float):
        """Advance the clock; residuals are time functions, so a new ``now``
        invalidates every cached entry."""
        if self._now is None or now != self._now:
            self.valid[:] = False
            self._now = float(now)

    def place(self, ni: int, lane: int, now: float):
        """Resident set grows: only the node's True entries can change
        (residual shrank monotonically), so False entries stay valid."""
        self.running[ni].append(lane)
        self.admit_t[lane] = now
        self.valid[ni] &= ~self.fits[ni]
        self._push_admit(lane)

    def release(self, ni: int, lane: int):
        """Resident set shrinks: the residual grew, False entries may flip
        True — the node's whole column is invalid."""
        self.running[ni].remove(lane)
        self.valid[ni] = False

    def is_valid(self, ni: int, lane: int) -> bool:
        return bool(self.valid[ni, lane])

    # ---------------------------------------------------------------- refresh
    def columns(self, now: float, lanes: Sequence[int]) -> np.ndarray:
        """Fits matrix slice ``(N, len(lanes))``, refreshed where invalid.

        On the fused backend every invalid ``(node, lane)`` entry across
        all nodes is recomputed in one batch of device operations, read
        back in one host read.
        """
        self.sync_now(now)
        lanes = np.asarray(lanes, np.int64)
        stale = ~self.valid[:, lanes]
        if stale.any():
            todo = lanes[stale.any(axis=0)]
            nodes = np.nonzero(stale.any(axis=1))[0]
            if self.backend == "numpy":
                self._refresh_numpy(nodes, todo)
            else:
                self._refresh_fused(nodes, todo)
            self.valid[np.ix_(nodes, todo)] = True
        return self.fits[:, lanes]

    def _refresh_numpy(self, nodes: np.ndarray, lanes: np.ndarray):
        """Float64 host reference: per-node :func:`fits_column` — the
        exact arithmetic of the packed ClusterSim engine."""
        grid_abs = self._now + self.grid[lanes]
        for ni in nodes:
            run = self.running[ni]
            ok, resid = fits_column(
                self.caps[ni], self.starts[run], self.peaks[run],
                self.admit_t[run], self.need[lanes], grid_abs,
                dur=self.dur[run] if self.use_dur else None, tol=self.tol)
            self.fits[ni, lanes] = ok
            self.minresid[ni, lanes] = resid.min(axis=-1)

    # ------------------------------------------------------------ fused path
    def _dev_sync(self):
        """(Re)upload the packed lane state to the device (bulk path; the
        incremental paths update the resident buffers in place).  After
        the initial upload this fires again only when lanes are added or
        the segment axis grows — never on node join/leave, which only
        change the operands of the next program."""
        record_dispatch("admission.dev_sync")
        up = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.float64)).to(self.device)
        self._dstarts = up(self.starts)
        self._dpeaks = up(self.peaks)
        self._dneed = up(self.need)
        self._dgrid = up(self.grid)
        # one spare slot past the last lane: the drain's unused placement
        # slots scatter their admission time there
        self._dadmit = up(np.append(self.admit_t, 0.0))
        self._ddur = up(self.dur)
        self._dirty_dev = False

    def _push_lanes(self, lanes: np.ndarray):
        """In-place device update of re-planned lanes."""
        if self.backend == "numpy" or self._dirty_dev:
            return
        record_dispatch("admission.scatter", 3)
        rows = torch.from_numpy(np.asarray(lanes, np.int64)).to(self.device)
        for buf, host in ((self._dstarts, self.starts),
                          (self._dpeaks, self.peaks),
                          (self._dneed, self.need)):
            buf.index_copy_(0, rows, torch.from_numpy(
                np.ascontiguousarray(host[lanes])).to(self.device))

    def _push_admit(self, lane: int):
        if self.backend == "numpy" or self._dirty_dev:
            return
        record_dispatch("admission.scatter")
        self._dadmit[lane] = float(self.admit_t[lane])

    def _operands(self, rows: Sequence[int], lanes, now: float):
        """The per-call operands of a fused program, in two uploads: the
        residents of node ``rows`` (``(N, R)`` index and validity, ``R``
        the longest resident list, at least 1) with the queued lanes, and
        the float64 ``caps``, ``now`` and ``tol``."""
        sel = [self.running[ni] for ni in rows]
        R = max(max((len(r) for r in sel), default=0), 1)
        N, Q = len(sel), len(lanes)
        ints = np.zeros((2 * N * R + Q,), np.int64)
        run_idx = ints[:N * R].reshape(N, R)
        run_valid = ints[N * R:2 * N * R].reshape(N, R)
        for i, run in enumerate(sel):
            run_idx[i, :len(run)] = run
            run_valid[i, :len(run)] = 1
        ints[2 * N * R:] = lanes
        dints = torch.from_numpy(ints).to(self.device)
        flts = torch.from_numpy(np.concatenate(
            [self.caps[np.asarray(rows, np.int64)], [now, self.tol]])
        ).to(self.device)
        return (flts[:N], dints[:N * R].view(N, R),
                dints[N * R:2 * N * R].view(N, R) != 0, dints[2 * N * R:],
                flts[N], flts[N + 1])

    def _refresh_fused(self, nodes: np.ndarray, lanes: np.ndarray):
        """One batch of device operations for every invalid (node, lane)
        entry, and one host read.

        Only the stale node rows enter the program — after a placement,
        that is a single node over the previously-True lanes, not the
        whole matrix::

            resid[n, q, g] = cap[n] - sum_r alloc_r(now + grid[q, g] - t0[r])
            fits[n, q]     = all_g need[q, g] <= resid[n, q, g] + tol
            minresid[n, q] = min_g resid[n, q, g]
        """
        record_dispatch("admission.columns")
        if self._dirty_dev:
            self._dev_sync()
        caps, run_idx, run_valid, q_idx, now, tol = self._operands(
            nodes, lanes, self._now)
        tabs = (now + self._dgrid[q_idx]).reshape(-1)
        resid = _residual(self._dstarts, self._dpeaks, self._dadmit,
                          self._ddur, caps, run_idx, run_valid, tabs,
                          self.use_dur).reshape(len(nodes), -1, self.G)
        fits = (self._dneed[q_idx][None] <= resid + tol).all(dim=-1)
        out = torch.stack([fits.to(torch.float64), resid.amin(dim=-1)]).cpu().numpy()
        self.stats["host_reads"] += 1
        self.fits[np.ix_(nodes, lanes)] = out[0] != 0
        self.minresid[np.ix_(nodes, lanes)] = out[1]

    # ------------------------------------------------------------------ drain
    def drain(self, now: float, lanes: Sequence[int],
              select: str = "first") -> List[tuple]:
        """Greedy drain at ``now`` over ``lanes`` (queue order): place
        lanes until none fits, returning ``[(lane, node_row), ...]`` in
        decision order.

        On the fused backend this is the device drain program
        (:meth:`_drain_fused`): a loop of device steps over resident state
        with one host read per iteration, the admission-time scatter for
        every placement included.  On the numpy backend it is the host
        reference loop over :meth:`columns` — the oracle the device program
        is held to.

        ``select="first"`` is the ClusterSim rule (first fitting node in
        row order); ``select="headroom"`` is the ElasticPlanner rule
        (most post-placement head-room, first on ties).  Decision
        equivalence with the sequential greedy holds because placements
        only shrink residuals: an unfit lane can never become fit within
        one drain, and a fitting lane whose fitting-node set is disjoint
        from the drain's earlier placements reads only unchanged state.

        Queue routing (fused): a queue of at most ``DRAIN_CAP`` lanes goes
        straight into the program, whole.  A wider backlog first runs the
        candidate pre-filter: base-residual fits of the whole queue from
        :meth:`columns` — the incremental, validity-cached refresh — and
        the program runs over *just the lanes that fit somewhere*.  The
        restriction is exact by residual monotonicity (a lane unfit on the
        base residuals can never place within the drain).
        """
        if _obs.enabled:
            q = int(np.asarray(lanes).size)
            with _obs.span("admission.drain", backend=self.backend,
                           q=q) as sp:
                out = self._drain(now, lanes, select)
                sp.add(placed=len(out))
                _met.hist("admission.drain.lanes",
                          buckets=_met.COUNT_BUCKETS).observe(q)
                _met.hist("admission.drain.placed",
                          buckets=_met.COUNT_BUCKETS).observe(len(out))
            return out
        return self._drain(now, lanes, select)

    def _drain(self, now: float, lanes: Sequence[int],
               select: str) -> List[tuple]:
        if select not in ("first", "headroom"):
            raise ValueError(f"unknown drain select rule: {select!r}")
        self.sync_now(now)
        self.stats["drains"] += 1
        lanes = [int(x) for x in np.asarray(lanes, np.int64).reshape(-1)]
        if not lanes or self.N == 0:
            return []
        if self.backend == "numpy":
            return self._drain_host(now, lanes, select)
        placed_all: List[tuple] = []
        remaining = lanes
        while True:
            if len(remaining) <= self.DRAIN_CAP:
                # Narrow queue: the whole thing goes into the program.
                placed_all.extend(self._drain_fused(now, remaining, select))
                break
            idx = np.nonzero(
                self.columns(now, remaining).any(axis=0))[0]
            if idx.size == 0:
                break
            cand = [remaining[i] for i in idx[:self.DRAIN_CAP]]
            placed = self._drain_fused(now, cand, select)
            placed_all.extend(placed)
            if idx.size <= self.DRAIN_CAP or not placed:
                # A single chunk held every candidate — the program's own
                # termination condition verified exhaustion — or the
                # program disagreed with the cache inside the float64
                # grazing band (precision contract) and made no progress.
                break
            got = {ji for ji, _ in placed}
            remaining = [ji for ji in remaining if ji not in got]
        return placed_all

    def _drain_host(self, now: float, lanes: List[int],
                    select: str) -> List[tuple]:
        """Host reference drain: the exact per-placement columns/argmax
        loop."""
        placed: List[tuple] = []
        if select == "first":
            remaining = list(lanes)
            while remaining:
                M = self.columns(now, remaining)
                anyfit = M.any(axis=0)
                if not anyfit.any():
                    break
                col = int(np.argmax(anyfit))
                ni = int(np.argmax(M[:, col]))
                lane = remaining.pop(col)
                self.place(ni, lane, now)
                placed.append((lane, ni))
        else:
            for lane in lanes:
                col = self.columns(now, [lane])[:, 0]
                if not col.any():
                    continue
                head = self.minresid[:, lane] - float(self.peaks[lane].max())
                ni = int(np.argmax(np.where(col, head, -np.inf)))
                self.place(ni, lane, now)
                placed.append((lane, ni))
        return placed

    def _drain_fused(self, now: float, lanes: List[int],
                     select: str) -> List[tuple]:
        """The device drain program over ``lanes`` (queue order).

        Base residuals ``resid[n, q, g]`` are computed once from the
        current residents (the program of :meth:`_refresh_fused`); then
        each iteration, all on the device:

        1. recomputes ``fits[n, q]`` from the carried residuals,
        2. places a maximal *order-preserving independent prefix* of the
           queue in one step.  Residual monotonicity proves the picks
           independent: walking lanes in queue order, every fitting lane
           whose fitting-node set is disjoint from the nodes already used
           *this iteration* would be chosen identically by the sequential
           greedy, because none of the entries its decision reads have
           changed.  The prefix stops at the first fitting lane whose fit
           set intersects a used node — it is re-evaluated next iteration,
        3. subtracts each placed lane's windowed envelope from its node's
           residual rows (at most one lane per node per iteration, by the
           cut) and clears the lane's active bit,

        and the host reads one small vector (done flag, count, placement
        list): one host read per iteration, until no queued lane fits.
        The placed lanes' admission times are then scattered into the
        resident ``admit_t`` buffer in place; unused placement slots write
        to a spare slot past the end, which is never read.
        """
        if self._dirty_dev:
            self._dev_sync()
        N, Q, G, B = self.N, len(lanes), self.G, self.B
        dev = self.device
        caps, run_idx, run_valid, q_idx, now_t, tol = self._operands(
            range(N), lanes, now)
        starts, peaks, dur = self._dstarts, self._dpeaks, self._ddur
        tabs = (now_t + self._dgrid[q_idx]).reshape(-1)    # (Q*G,) absolute
        resid = _residual(starts, peaks, self._dadmit, dur, caps, run_idx,
                          run_valid, tabs, self.use_dur).reshape(N, Q, G)
        need_q = self._dneed[q_idx]
        if select == "headroom":
            peak_q = peaks[q_idx].amax(dim=1)
        # A lane placed inside this drain has admit_t == now *exactly*, so
        # its contribution at grid point (q, g) is evaluated at
        # rel = (now + grid[q, g]) - now — kept in this form (not
        # simplified to grid[q, g]) so the arithmetic matches what the
        # refresh computes for that resident afterwards, bitwise.
        prel = tabs - now_t
        prelc = prel.clamp_min(0.0)[None, :].expand(N, -1)
        nrange = torch.arange(N, device=dev)
        qrange = torch.arange(Q, device=dev)
        spare_q = torch.full((), Q, dtype=torch.int64, device=dev)
        spare_n = torch.full((), N, dtype=torch.int64, device=dev)
        active = torch.ones((Q,), dtype=torch.bool, device=dev)
        # slot Q of the placement list and slot N of the node -> lane map
        # are the spares that absorb the unplaced lanes' scatters
        out = torch.full((2, Q + 1), B, dtype=torch.int64, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        self.stats["drain_dispatches"] += 1
        record_dispatch("admission.drain")
        while True:
            self.stats["drain_iterations"] += 1
            fits = (need_q[None] <= resid + tol).all(dim=-1) & active[None]
            anyfit = fits.any(dim=0)                         # (Q,)
            done = ~anyfit.any()
            if select == "first":
                node_q = fits.to(torch.int8).argmax(dim=0)
            else:
                head = resid.amin(dim=-1) - peak_q[None, :]
                node_q = torch.where(fits, head, -torch.inf).argmax(dim=0)
            onehot = (nrange[:, None] == node_q[None, :]) & anyfit[None, :]
            oh = onehot.to(torch.int32)
            before = (oh.cumsum(dim=1) - oh) > 0
            conflict = anyfit & (fits & before).any(dim=0)
            first_conf = torch.where(
                conflict.any(), conflict.to(torch.int8).argmax(), spare_q)
            place = anyfit & (qrange < first_conf) & ~done
            slot = torch.where(place, count + place.cumsum(dim=0) - 1,
                               spare_q)
            out[0].index_put_((slot,), q_idx)
            out[1].index_put_((slot,), node_q)
            count = count + place.sum()
            col = torch.full((N + 1,), Q, dtype=torch.int64, device=dev)
            col.index_put_((torch.where(place, node_q, spare_n),), qrange)
            col = col[:N]
            hasl = col < Q
            gl = q_idx[torch.where(hasl, col, 0)]
            pal = _alloc_chain(starts[gl], peaks[gl], prelc)
            if self.use_dur:
                pal = torch.where((prel[None, :] >= 0.0)
                                  & (prel[None, :] < dur[gl][:, None]
                                     + WINDOW), pal, 0.0)
            pal = torch.where(hasl[:, None], pal, 0.0)
            resid = resid - pal.reshape(N, Q, G)
            active = active & ~place
            # the one host read of this iteration
            host = torch.cat([torch.stack([done.to(torch.int64), count]),
                              out[:, :Q].reshape(-1)]).cpu().numpy()
            self.stats["host_reads"] += 1
            if host[0]:
                break
        n = int(host[1])
        # Admission times of the placed lanes, scattered in place; unused
        # slots hold lane B, the spare slot of the buffer.  (Slot Q of the
        # placement list absorbed the unplaced lanes' writes: not read.)
        self._dadmit.index_fill_(0, out[0, :Q], float(now))
        placed: List[tuple] = []
        for lane, ni in zip(host[2:2 + n].tolist(),
                            host[2 + Q:2 + Q + n].tolist()):
            # Host bookkeeping per placement; the device-side admit_t
            # scatter already happened above.
            self.running[ni].append(lane)
            self.admit_t[lane] = now
            # Monotonic rule (same as place()): the placement only shrank
            # node ni's residual, so the pre-filter's cached False entries
            # stay valid; only the Trues must be recomputed on the next
            # refresh.
            self.valid[ni] &= ~self.fits[ni]
            placed.append((lane, ni))
        return placed
