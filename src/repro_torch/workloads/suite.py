"""Robustness suite: scenario catalog x arrival process x fault schedule.

:func:`make_suite` enumerates a seeded grid of stress cases and
:func:`run_suite` replays each one through
:class:`repro_torch.sched.ClusterSim` on a device, producing one wastage /
failure / doomed-work table (:func:`suite_table`).  The default grid
deliberately excludes ``heavy_tail`` — its elephants can exceed every
node's capacity at attempt 1, which the simulator rejects at submit
(fail-fast) — and ``workload_replay`` (fleet-scale; ``chip_smoke.py``
replays it on its own).

Every case is reproducible from its ``(scenario, arrival, fault, seed)``
tuple and the device alone: arrivals and faults are seeded per-case, so
the fused engine's rows can be re-checked bitwise against the legacy
oracle (``check_oracle=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.obs import trace as _obs
from repro_torch.workloads import scenarios as _scen
from repro_torch.workloads.arrivals import diurnal_arrivals, poisson_arrivals

__all__ = ["SuiteCase", "make_suite", "run_suite", "suite_table",
           "DEFAULT_SCENARIOS", "DEFAULT_ARRIVALS", "DEFAULT_FAULTS"]

DEFAULT_SCENARIOS = ("burst_arrival", "deep_chain", "wide_fanout")
DEFAULT_ARRIVALS = ("none", "poisson", "diurnal")
DEFAULT_FAULTS = ("none", "storm", "churn")


@dataclasses.dataclass(frozen=True)
class SuiteCase:
    """One grid point; fully determines a replay given a fleet."""

    scenario: str
    arrival: str                 # "none" | "poisson" | "diurnal"
    fault: str                   # "none" | "storm" | "churn" | "rack"
    seed: int = 0
    n_tasks: Optional[int] = None

    @property
    def name(self) -> str:
        return f"{self.scenario}/{self.arrival}/{self.fault}/s{self.seed}"


def make_suite(scenarios: Sequence[str] = DEFAULT_SCENARIOS,
               arrivals: Sequence[str] = DEFAULT_ARRIVALS,
               faults: Sequence[str] = DEFAULT_FAULTS,
               seeds: Sequence[int] = (0,),
               n_tasks: Optional[int] = None) -> List[SuiteCase]:
    """The full seeded grid, scenario-major (stable, documented order)."""
    for s in scenarios:
        if s not in _scen.SCENARIOS:
            raise KeyError(f"unknown scenario: {s!r}")
    bad_a = set(arrivals) - set(DEFAULT_ARRIVALS)
    if bad_a:
        raise ValueError(f"unknown arrival kinds: {sorted(bad_a)}")
    bad_f = set(faults) - {"none", "storm", "churn", "rack"}
    if bad_f:
        raise ValueError(f"unknown fault kinds: {sorted(bad_f)}")
    return [SuiteCase(s, a, f, seed=sd, n_tasks=n_tasks)
            for s in scenarios for a in arrivals for f in faults
            for sd in seeds]


def _case_jobs(case: SuiteCase, n_tasks: int, device):
    wf = _scen.get(case.scenario, n_tasks=n_tasks, seed=case.seed,
                   device=device)
    if case.arrival == "poisson":
        rel = poisson_arrivals(wf.B, rate=0.5, seed=case.seed,
                               parents=wf.parents)
        wf = dataclasses.replace(wf, release_times=rel)
    elif case.arrival == "diurnal":
        rel = diurnal_arrivals(wf.B, base_rate=0.5, period=600.0,
                               depth=0.8, seed=case.seed,
                               parents=wf.parents)
        wf = dataclasses.replace(wf, release_times=rel)
    return wf.to_jobs(seed=case.seed, under_frac=0.15)


def _case_faults(case: SuiteCase, nodes):
    from repro_torch.sched.faults import FaultSchedule
    if case.fault == "none":
        return None
    if case.fault == "storm":
        return FaultSchedule.preemption_storm(
            nodes, t=60.0, frac=0.5, seed=case.seed, down_time=120.0)
    if case.fault == "churn":
        return FaultSchedule.node_churn(
            nodes, rate=1.0 / 120.0, horizon=900.0, seed=case.seed,
            mean_down=90.0)
    # "rack": the odd-numbered nodes share one failure domain
    rack_of = {int(n.nid): int(n.nid) % 2 for n in nodes}
    return FaultSchedule.rack_failure(nodes, rack_of, rack=1, t=90.0,
                                      down_time=180.0)


def _default_nodes():
    from repro_torch.sched import Node
    return [Node(0, 48.0), Node(1, 64.0), Node(2, 32.0)]


def run_suite(cases: Sequence[SuiteCase], nodes=None, retry=None,
              engine: str = "fused", n_tasks: int = 96,
              check_oracle: bool = False,
              device=None) -> List[Dict[str, object]]:
    """Replay each case on ``device`` (None means the card; the scenarios
    are synthesized and the engines run there); one metrics row per case.

    With ``check_oracle`` every case is replayed twice and the fused (or
    packed) placement log is asserted bitwise-identical to the legacy
    per-job oracle — the robustness suite's differential guarantee.
    """
    from repro_torch.core import RetrySpec, ksplus_retry
    from repro_torch.sched import ClusterSim, Node

    device = resolve_device(device)

    if retry is None:
        retry = RetrySpec("ksplus")

    def fresh_fleet():
        base = nodes() if callable(nodes) else nodes
        if base is None:
            return _default_nodes()
        return [Node(n.nid, n.capacity_gb) for n in base]

    rows: List[Dict[str, object]] = []
    for case in cases:
        nt = case.n_tasks or n_tasks
        fleet = fresh_fleet()
        jobs = _case_jobs(case, nt, device)
        faults = _case_faults(case, fleet)
        if _obs.enabled:
            with _obs.span("suite.case", case=case.name, jobs=len(jobs)):
                res = ClusterSim(fleet, engine=engine, device=device).run(
                    jobs, retry, faults=faults)
        else:
            res = ClusterSim(fleet, engine=engine, device=device).run(
                jobs, retry, faults=faults)
        if check_oracle:
            oracle = ClusterSim(fresh_fleet(), engine="legacy",
                                device=device).run(
                _case_jobs(case, nt, device), ksplus_retry, faults=faults)
            if oracle.placements != res.placements:
                raise AssertionError(
                    f"{case.name}: {engine} placements diverge from the "
                    f"legacy oracle")
            np.testing.assert_allclose(
                res.total_wastage_gbs, oracle.total_wastage_gbs, rtol=1e-6)
        rows.append({
            "case": case.name,
            "jobs": len(jobs),
            "makespan": float(res.makespan),
            "wastage_gbs": float(res.total_wastage_gbs),
            "utilization": float(res.avg_utilization),
            "retries": int(res.retries),
            "evictions": int(res.evictions),
            "unschedulable": int(res.unschedulable),
            "doomed": int(res.doomed),
            "starved": int(res.starved),
            "starvation_s": float(res.starvation_s),
            "finished": int(res.finished),
        })
    return rows


_COLS: Tuple[Tuple[str, int], ...] = (
    ("case", 34), ("jobs", 6), ("makespan", 10), ("wastage_gbs", 12),
    ("utilization", 6), ("retries", 7), ("evictions", 6),
    ("unschedulable", 7), ("doomed", 6), ("starved", 7),
    ("starvation_s", 12),
)


def suite_table(rows: Sequence[Dict[str, object]]) -> str:
    """Fixed-width text table of :func:`run_suite` rows."""
    head = "  ".join(f"{name:>{w}}" if name != "case" else f"{name:<{w}}"
                     for name, w in _COLS)
    lines = [head, "-" * len(head)]
    for r in rows:
        cells = []
        for name, w in _COLS:
            v = r[name]
            if isinstance(v, float):
                cells.append(f"{v:>{w}.2f}")
            elif name == "case":
                cells.append(f"{v:<{w}}")
            else:
                cells.append(f"{v:>{w}}")
        lines.append("  ".join(cells))
    return "\n".join(lines)
