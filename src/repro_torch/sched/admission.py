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
  - ``backend="fused"`` — float64 on a device (None means the card): on
    the card one ``admit_columns`` launch per refresh computes every
    invalid ``(node, lane)`` entry at once, and one ``admit_drain`` launch
    runs a whole greedy drain over resident state (:meth:`drain`), read
    back once (:mod:`repro_torch.kernels.admission`; on the CPU their
    plain versions).  The
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

``shard=n`` splits the drain's node axis over the ``n`` ranks of a
``torch.distributed`` process group (:meth:`AdmissionState._drain_sharded`,
the reference's ``shard_map`` over nodes): each rank runs the same replay,
holds the residual block of its own nodes and takes part in two
collective reductions per placement (three for ``select="headroom"``);
the placement list is the same on every rank.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import record_dispatch
from repro_torch.core.envelope import PAD_START, fits_column
from repro_torch.device import process_world, resolve_device
from repro_torch.kernels.admission import ops as _aops
from repro_torch.kernels.admission.ref import WINDOW, _alloc_chain, _residual
from repro_torch.obs import metrics as _met
from repro_torch.obs import trace as _obs

__all__ = ["AdmissionState"]

PAD_CAP = -1e30  # capacity of the padding rows of a sharded node axis


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
    backend runs on ``device`` (None means the card).

    ``shard=n`` runs the drain node-sharded (:meth:`_drain_sharded`) over
    a process group of ``n`` ranks, one per shard, as the reference needs
    ``n`` devices; other group sizes raise :class:`ValueError`.  With no
    group, ``shard=1`` starts a one-rank group over ``device`` for the
    state's lifetime (:meth:`close`, or the end of a ``with`` block,
    destroys it; a caller's group is never destroyed).  The node axis is
    padded to a multiple of ``n`` with ``-1e30`` capacities and rank ``r``
    owns nodes ``[r·Nl, (r+1)·Nl)``; node joins and leaves recompute the
    blocks.

    :attr:`stats` counts ``drains``, the fused drain programs run
    (``drain_dispatches``), their loop iterations (``drain_iterations``),
    the device-to-host reads of the fused backend (``host_reads``: one
    per fused refresh and one per drain on the card; one per drain
    iteration on the CPU and in a sharded drain) and the collective
    reductions of a sharded drain (``collectives``).
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
        self.shard = shard
        self.device = resolve_device(device) if backend == "fused" else None
        self.stats = {"drains": 0, "drain_dispatches": 0,
                      "drain_iterations": 0, "host_reads": 0,
                      "collectives": 0}
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
        world = contextlib.ExitStack()
        self._finalizer = weakref.finalize(self, world.close)
        if shard is not None:
            self._join_world(world)
            self._reshard()

    # ------------------------------------------------------- process group
    def _join_world(self, world: contextlib.ExitStack):
        """The process group of a sharded drain: the caller's, of exactly
        ``shard`` ranks, or (``shard=1`` and none) a one-rank group held
        by ``world`` until :meth:`close`."""
        import torch.distributed as dist
        if dist.is_initialized():
            have = dist.get_world_size()
            if have != self.shard:
                raise ValueError(
                    f"shard={self.shard} needs a process group of "
                    f"{self.shard} ranks (one per shard), but the group "
                    f"has {have}")
        elif self.shard == 1:
            world.enter_context(process_world(self.device))
        else:
            raise ValueError(
                f"shard={self.shard} needs a process group of {self.shard} "
                f"ranks (one per shard): initialise one with "
                f"torch.distributed.init_process_group")
        self._rank = dist.get_rank()

    def _reshard(self):
        """This rank's block of the node axis, padded to a multiple of
        ``shard``: rows ``[lo, lo + nl)`` (rows past ``N`` are padding)."""
        self._nl = -(-max(self.N, 1) // self.shard)
        self._lo = self._rank * self._nl

    def close(self) -> None:
        """Destroy the one-rank process group this state started, if any;
        a group the caller made is left as it is."""
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

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
        if self.shard:
            self._reshard()
        return self.N - 1

    def remove_node(self, ni: int) -> List[int]:
        """Drop a node row; returns the lanes that were resident on it."""
        evicted = self.running[ni]
        self.caps = np.delete(self.caps, ni)
        del self.running[ni]
        self.fits = np.delete(self.fits, ni, axis=0)
        self.valid = np.delete(self.valid, ni, axis=0)
        self.minresid = np.delete(self.minresid, ni, axis=0)
        if self.shard:
            self._reshard()
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
        residents of node ``rows`` (``(N, R)`` index and validity, nonzero
        where valid; ``R`` the longest resident list, at least 1) with the
        queued lanes, and the float64 ``caps``, ``now`` and ``tol``.  A row
        past the last node is padding: no residents, capacity
        ``PAD_CAP``."""
        rows = np.asarray(rows, np.int64)
        real = rows < self.N
        sel = [self.running[ni] if ok else []
               for ni, ok in zip(rows.tolist(), real)]
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
        caps = np.full(rows.shape, PAD_CAP)
        caps[real] = self.caps[rows[real]]
        flts = torch.from_numpy(np.concatenate([caps, [now, self.tol]])
                                ).to(self.device)
        return (flts[:N], dints[:N * R].view(N, R),
                dints[N * R:2 * N * R].view(N, R), dints[2 * N * R:],
                flts[N], flts[N + 1])

    def _lane_state(self):
        """The resident lane buffers, in the admission kernels' order."""
        if self._dirty_dev:
            self._dev_sync()
        return (self._dstarts, self._dpeaks, self._dadmit, self._ddur,
                self._dneed, self._dgrid)

    def _refresh_fused(self, nodes: np.ndarray, lanes: np.ndarray):
        """Every invalid (node, lane) entry in one program and one host
        read: one ``admit_columns`` launch on the card.

        Only the stale node rows enter the program — after a placement,
        that is a single node over the previously-True lanes, not the
        whole matrix::

            resid[n, q, g] = cap[n] - sum_r alloc_r(now + grid[q, g] - t0[r])
            fits[n, q]     = all_g need[q, g] <= resid[n, q, g] + tol
            minresid[n, q] = min_g resid[n, q, g]
        """
        record_dispatch("admission.columns")
        lane_state = self._lane_state()
        out = _aops.admit_columns(
            *lane_state, *self._operands(nodes, lanes, self._now),
            self.use_dur).cpu().numpy()
        self.stats["host_reads"] += 1
        self.fits[np.ix_(nodes, lanes)] = out[0] != 0
        self.minresid[np.ix_(nodes, lanes)] = out[1]

    # ------------------------------------------------------------------ drain
    def drain(self, now: float, lanes: Sequence[int],
              select: str = "first") -> List[tuple]:
        """Greedy drain at ``now`` over ``lanes`` (queue order): place
        lanes until none fits, returning ``[(lane, node_row), ...]`` in
        decision order.

        On the fused backend this is the drain program
        (:meth:`_drain_fused`): on the card one launch over resident state
        and one host read, the admission-time scatter for every placement
        included.  On the numpy backend it is the host
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
        program = self._drain_sharded if self.shard else self._drain_fused
        placed_all: List[tuple] = []
        remaining = lanes
        while True:
            if len(remaining) <= self.DRAIN_CAP:
                # Narrow queue: the whole thing goes into the program.
                placed_all.extend(program(now, remaining, select))
                break
            idx = np.nonzero(
                self.columns(now, remaining).any(axis=0))[0]
            if idx.size == 0:
                break
            cand = [remaining[i] for i in idx[:self.DRAIN_CAP]]
            placed = program(now, cand, select)
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
        """The drain program over ``lanes`` (queue order): the reference's
        ``_drain_kernel``, one ``admit_drain`` launch on the card
        (:func:`repro_torch.kernels.admission.ref.plain_drain` on the CPU).

        The program computes the base residuals from the current residents,
        then places order-preserving independent prefixes of the queue
        until no lane fits, and scatters the placed lanes' admission times
        into the resident ``admit_t`` buffer.  The host reads its vector
        (count, iterations, placement list) once; the plain loop on the CPU
        reads its done flag every iteration.
        """
        lane_state = self._lane_state()
        self.stats["drain_dispatches"] += 1
        record_dispatch("admission.drain")
        vec, reads = _aops.admit_drain(
            *lane_state, *self._operands(range(self.N), lanes, now),
            self.use_dur, select)
        # the one host read of this drain (on the card)
        host = vec.cpu().numpy()
        self.stats["drain_iterations"] += int(host[1])
        self.stats["host_reads"] += reads
        return self._book(now, host, len(lanes))

    def _book(self, now: float, host: np.ndarray, Q: int) -> List[tuple]:
        """A drain program's placements (``host``: the count, a word not
        read here, ``lanes[Q]``, ``nodes[Q]``) into the host bookkeeping;
        their admission times are already in the device's ``admit_t``."""
        n = int(host[0])
        placed: List[tuple] = []
        for lane, ni in zip(host[2:2 + n].tolist(),
                            host[2 + Q:2 + Q + n].tolist()):
            self.running[ni].append(lane)
            self.admit_t[lane] = now
            # Monotonic rule (same as place()): the placement only shrank
            # node ni's residual, so the pre-filter's cached False entries
            # stay valid; only the Trues must be recomputed on the next
            # refresh.
            self.valid[ni] &= ~self.fits[ni]
            placed.append((lane, ni))
        return placed

    def _drain_sharded(self, now: float, lanes: List[int],
                       select: str) -> List[tuple]:
        """The node-sharded drain program over ``lanes`` (queue order):
        the reference's ``_drain_kernel_sharded`` over this process group.

        This rank computes the base residuals of its own block of nodes
        only, ``(Nl, Q, G)`` float64 (padding rows never fit), then each
        iteration:

        1. computes its local fits,
        2. all-reduces the per-lane "any rank fits" (MAX over int32),
        3. takes the first fitting lane in queue order and all-reduces the
           winning global node index (MIN over the indices of the nodes it
           fits; for ``select="headroom"`` first the MAX of the head-room,
           then the MIN of the indices that reach it: first on ties, as
           ``np.argmax``),
        4. the owning rank subtracts the lane's windowed envelope from its
           node's rows,
        5. the placement list (the same on every rank) grows by one,
        6. one host read: the done flag, the count and the list.

        One placement per iteration: the selection is globally ordered,
        and each node sees the subtractions of the one-device program in
        the same order, so the decisions are the unsharded drain's.
        """
        import torch.distributed as dist
        if self._dirty_dev:
            self._dev_sync()
        Q, G, B = len(lanes), self.G, self.B
        nl, lo = self._nl, self._lo
        dev = self.device
        caps, run_idx, run_valid, q_idx, now_t, tol = self._operands(
            range(lo, lo + nl), lanes, now)
        starts, peaks, dur = self._dstarts, self._dpeaks, self._ddur
        tabs = (now_t + self._dgrid[q_idx]).reshape(-1)    # (Q*G,) absolute
        resid = _residual(starts, peaks, self._dadmit, dur, caps, run_idx,
                          run_valid, tabs, self.use_dur).reshape(nl, Q, G)
        need_q = self._dneed[q_idx]
        if select == "headroom":
            peak_q = peaks[q_idx].amax(dim=1)
        # as in plain_drain: the placed lane's rel kept as now + grid - now
        prel = tabs - now_t
        prelc = prel.clamp_min(0.0)[None, :]
        gidx = torch.arange(lo, lo + nl, dtype=torch.int64, device=dev)
        node_ok = gidx < self.N
        lrange = gidx - lo
        qrange = torch.arange(Q, dtype=torch.int64, device=dev)
        big = torch.full((), nl * self.shard, dtype=torch.int64, device=dev)
        spare_q = torch.full((), Q, dtype=torch.int64, device=dev)
        active = torch.ones((Q,), dtype=torch.bool, device=dev)
        out = torch.full((2, Q + 1), B, dtype=torch.int64, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        self.stats["drain_dispatches"] += 1
        record_dispatch("admission.drain")
        while True:
            self.stats["drain_iterations"] += 1
            fits = (need_q[None] <= resid + tol).all(dim=-1) \
                & active[None] & node_ok[:, None]
            anyfit = fits.any(dim=0).to(torch.int32)          # (Q,)
            dist.all_reduce(anyfit, op=dist.ReduceOp.MAX)
            anyfit = anyfit > 0
            done = ~anyfit.any()
            qsel = anyfit.to(torch.int8).argmax()
            colf = fits[:, qsel]
            if select == "first":
                nsel = torch.where(colf, gidx, big).amin()
            else:
                head = torch.where(colf, resid[:, qsel].amin(dim=-1)
                                   - peak_q[qsel], -torch.inf)
                best = head.amax()
                dist.all_reduce(best, op=dist.ReduceOp.MAX)
                self.stats["collectives"] += 1
                nsel = torch.where(colf & (head == best), gidx, big).amin()
            dist.all_reduce(nsel, op=dist.ReduceOp.MIN)
            self.stats["collectives"] += 2
            place = ~done
            slot = torch.where(place, count, spare_q)
            gl = q_idx[qsel]
            out[0].index_put_((slot,), gl)
            out[1].index_put_((slot,), nsel)
            count = count + place.to(torch.int64)
            pal = _alloc_chain(starts[gl][None], peaks[gl][None], prelc)
            if self.use_dur:
                pal = torch.where((prel[None, :] >= 0.0)
                                  & (prel[None, :] < dur[gl] + WINDOW),
                                  pal, 0.0)
            own = place & (lrange == nsel - lo)               # (Nl,)
            resid = resid - torch.where(own[:, None, None],
                                        pal.reshape(1, Q, G), 0.0)
            active = active & ~(place & (qrange == qsel))
            # the one host read of this iteration
            host = torch.cat([torch.stack([count, done.to(torch.int64)]),
                              out[:, :Q].reshape(-1)]).cpu().numpy()
            self.stats["host_reads"] += 1
            if host[1]:
                break
        # the placed lanes' admission times, scattered in place; unused
        # slots hold lane B, the spare slot of the buffer
        self._dadmit.index_fill_(0, out[0, :Q], float(now))
        return self._book(now, host, Q)
