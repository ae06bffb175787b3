"""Seeded fault injection for the cluster simulator.

A :class:`FaultSchedule` is an immutable, time-sorted list of node
membership events — ``leave`` (the node dies / is preempted; resident
jobs are evicted) and ``join`` (a node enters the fleet with a given
capacity) — consumed by :meth:`repro_torch.sched.cluster.ClusterSim.run` via
its ``faults=`` argument.  All three engines inject the same schedule at
the same event times, so their decision logs agree bitwise under churn
(``tests/test_torch_sched.py``).

Eviction semantics (identical in every engine):

* each resident job of a leaving node is killed — its allocated area up
  to the eviction time counts as wastage, its attempt counter advances
  (the same :class:`repro_torch.core.envelope.RetrySpec` attempt budget that
  bounds OOM retries), and it re-enters the admission queue *ahead* of
  other waiters, in admission order;
* a job that runs out of attempts through evictions fails permanently —
  DAG descendants are doomed exactly like an OOM permanent failure;
* a job the surviving fleet cannot fit at all (its admission-need peak
  exceeds every remaining node's capacity) parks in a starvation-tracked
  side queue and re-enters on the next ``join`` instead of spinning in
  the admission queue (graceful degradation; see
  ``ClusterResult.starved`` / ``starvation_s``).

Constructors are seeded and deterministic: the same ``(nodes, args,
seed)`` always yields the same event list (``numpy.random.Generator``
over a tagged ``SeedSequence``).  Schedules compose with ``+`` — the
merge re-sorts by time, stably, so equal-time events keep their operand
order.

Device-drain coherence: the fused engine's default ``drain="device"``
path (:meth:`repro_torch.sched.admission.AdmissionState.drain`) does not read
the host-side fits cache at all — every drain recomputes fits from the
post-churn ``running``/``caps`` state on the device at the start of
each drain, so ``leave``/``join`` row splices need no device-side mask
rebuild; only the *host* fallback path consumes the incremental
invalidation protocol.  The port's parity tests pin both paths against
the reference (``tests/test_torch_sched.py``).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, Iterator, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = ["FaultEvent", "FaultSchedule"]

_KINDS = ("leave", "join")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One membership event: node ``nid`` leaves or joins at time ``t``.

    ``capacity_gb`` is required (positive) for joins — a joining node
    may rejoin with a different capacity than it left with — and unused
    for leaves.
    """

    t: float
    kind: str
    nid: int
    capacity_gb: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (choose from {_KINDS})")
        if not np.isfinite(self.t) or self.t < 0.0:
            raise ValueError(
                f"fault event time must be finite and >= 0, got {self.t!r}")
        if self.kind == "join" and not self.capacity_gb > 0.0:
            raise ValueError(
                f"join of node {self.nid} needs a positive capacity_gb, "
                f"got {self.capacity_gb!r}")


class FaultSchedule:
    """Immutable, stably time-sorted sequence of :class:`FaultEvent`s."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        events = list(events)
        for e in events:
            if not isinstance(e, FaultEvent):
                raise TypeError(f"not a FaultEvent: {e!r}")
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: e.t))  # stable: equal t keeps order

    # ------------------------------------------------------------- protocol
    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __add__(self, other: "FaultSchedule") -> "FaultSchedule":
        if not isinstance(other, FaultSchedule):
            return NotImplemented
        return FaultSchedule(self.events + other.events)

    def __repr__(self) -> str:
        return f"FaultSchedule({len(self.events)} events)"

    def validate(self, nids: Iterable[int]) -> None:
        """Replay the membership protocol against an initial fleet; raise
        loudly (naming the node) on a leave of an absent node or a join of
        a present one — the same checks every engine applies at runtime."""
        active = set(int(n) for n in nids)
        for e in self.events:
            if e.kind == "leave":
                if e.nid not in active:
                    raise KeyError(
                        f"fault schedule: leave of unknown or inactive "
                        f"node {e.nid} at t={e.t:g}")
                active.discard(e.nid)
            else:
                if e.nid in active:
                    raise ValueError(
                        f"fault schedule: join of already-active node "
                        f"{e.nid} at t={e.t:g}")
                active.add(e.nid)

    # --------------------------------------------------------- constructors
    @classmethod
    def preemption_storm(cls, nodes: Sequence, t: float, frac: float = 0.5,
                         seed: int = 0, down_time: float = None,
                         window: float = 5.0) -> "FaultSchedule":
        """Spot-style preemption: ~``frac`` of the fleet receives a
        termination notice within ``window`` seconds after ``t``; with
        ``down_time`` each victim rejoins (same capacity) that long after
        its own departure.  Victims and jitter are seeded."""
        nodes = list(nodes)
        if not nodes:
            raise ValueError("preemption_storm needs a non-empty fleet")
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), 0x570F]))
        k = min(max(int(round(frac * len(nodes))), 1), len(nodes))
        victims = sorted(
            int(v) for v in rng.choice(len(nodes), size=k, replace=False))
        events: List[FaultEvent] = []
        for vi in victims:
            node = nodes[vi]
            tl = float(t + rng.uniform(0.0, window))
            events.append(FaultEvent(tl, "leave", int(node.nid)))
            if down_time is not None:
                events.append(FaultEvent(tl + float(down_time), "join",
                                         int(node.nid),
                                         float(node.capacity_gb)))
        return cls(events)

    @classmethod
    def node_churn(cls, nodes: Sequence, rate: float, horizon: float,
                   seed: int = 0, mean_down: float = 60.0
                   ) -> "FaultSchedule":
        """Poisson node churn over ``[0, horizon)``: leave events arrive at
        ``rate`` per second, each taking down one uniformly-chosen up node,
        which rejoins after an Exp(``mean_down``) repair time.  Sequential
        seeded simulation — the down set evolves, so correlated multi-node
        outages emerge naturally at high rates."""
        if rate <= 0.0 or horizon <= 0.0:
            raise ValueError("node_churn needs rate > 0 and horizon > 0")
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), 0xC4C4]))
        up = {int(n.nid): float(n.capacity_gb) for n in nodes}
        repairs: List[Tuple[float, int, float]] = []  # (t_join, nid, cap)
        events: List[FaultEvent] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= horizon:
                break
            while repairs and repairs[0][0] <= t:
                _, nid, cap = heapq.heappop(repairs)
                up[nid] = cap
            if not up:
                continue
            nid = sorted(up)[int(rng.integers(len(up)))]
            cap = up.pop(nid)
            events.append(FaultEvent(t, "leave", nid))
            tj = t + float(rng.exponential(mean_down))
            heapq.heappush(repairs, (tj, nid, cap))
            events.append(FaultEvent(tj, "join", nid, cap))
        return cls(events)

    @classmethod
    def rack_failure(cls, nodes: Sequence, rack_of: Mapping[int, object],
                     rack, t: float, down_time: float = None
                     ) -> "FaultSchedule":
        """Correlated failure: every node of ``rack`` (one power/network
        domain, per the ``nid -> rack`` mapping) leaves at exactly ``t``;
        with ``down_time`` the whole rack rejoins together."""
        members = [n for n in nodes if rack_of.get(int(n.nid)) == rack]
        if not members:
            raise ValueError(f"rack_failure: no nodes in rack {rack!r}")
        events: List[FaultEvent] = []
        for node in members:
            events.append(FaultEvent(float(t), "leave", int(node.nid)))
        if down_time is not None:
            for node in members:
                events.append(FaultEvent(float(t) + float(down_time), "join",
                                         int(node.nid),
                                         float(node.capacity_gb)))
        return cls(events)
