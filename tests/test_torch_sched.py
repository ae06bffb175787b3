"""The port's ``sched/`` (faults, admission, cluster, elastic, monitor)
against the reference package, on the CPU.

The reference's own fused admission does not run in this environment, so
its oracles are the numpy admission backend and the ``packed`` and
``legacy`` engines, always named explicitly.  The contract is the
reference's: placements, retries, evictions, starved, doomed,
unschedulable and makespan exact; wastage and utilization within rtol
1e-6; fits equal and minimum residuals within 1e-12 relative.  Workloads
are reference scenarios carried into the port (``load_workflow_trace``),
so both packages replay the same traces.  ``tests/test_torch_sched_card.py``
holds the fused admission and engine on the card against the CPU.
"""

import numpy as np
import pytest
import torch

from repro.core import AllocationPlan as RPlan
from repro.core import RetrySpec as RSpec
from repro.core import ksplus_retry as r_ksplus_retry
from repro.sched import AdmissionState as RAdmission
from repro.sched import ClusterSim as RSim
from repro.sched import ElasticPlanner as RPlanner
from repro.sched import FaultEvent as RFaultEvent
from repro.sched import FaultSchedule as RFaults
from repro.sched import Job as RJob
from repro.sched import Node as RNode
from repro.sched import OffsetCandidate as ROffset
from repro.sched.elastic import plan_mesh as plan_mesh_ref
from repro.sched.monitor import HBMFootprintModel as RFootprint
from repro.workloads import arrivals as arr_ref
from repro.workloads import scenarios as scen_ref
from repro_torch.core import AllocationPlan, RetrySpec, ksplus_retry
from repro_torch.kernels.wastage import ops
from repro_torch.sched import (
    AdmissionState,
    ClusterSim,
    ElasticPlanner,
    FaultEvent,
    FaultSchedule,
    HBMFootprintModel,
    Job,
    MemoryMonitor,
    OffsetCandidate,
    plan_mesh,
    read_rss_gb,
)
from repro_torch.workloads import load_workflow_trace

from torch_cases import NODES, _assert_same, _lanes, _nodes

CPU = "cpu"


def _events(sched):
    return [(e.t, e.kind, e.nid, e.capacity_gb) for e in sched]


# ------------------------------------------------------------------ faults
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_fault_schedules_identical(seed):
    nodes, rnodes = _nodes(spec=NODES + ((3, 96.0), (4, 16.0))), \
        _nodes(RNode, NODES + ((3, 96.0), (4, 16.0)))
    for down in (None, 120.0):
        assert _events(FaultSchedule.preemption_storm(
            nodes, 60.0, 0.5, seed, down)) == _events(
            RFaults.preemption_storm(rnodes, 60.0, 0.5, seed, down))
    assert _events(FaultSchedule.node_churn(nodes, 1 / 60, 2000.0, seed,
                                            90.0)) == _events(
        RFaults.node_churn(rnodes, 1 / 60, 2000.0, seed, 90.0))
    rack_of = {n.nid: n.nid % 2 for n in nodes}
    both = FaultSchedule.rack_failure(nodes, rack_of, 1, 90.0, 180.0) \
        + FaultSchedule.preemption_storm(nodes, 10.0, seed=seed)
    assert _events(both) == _events(
        RFaults.rack_failure(rnodes, rack_of, 1, 90.0, 180.0)
        + RFaults.preemption_storm(rnodes, 10.0, seed=seed))


def test_fault_validation_same_errors():
    for bad in (dict(t=-1.0, kind="leave", nid=0),
                dict(t=1.0, kind="boom", nid=0),
                dict(t=1.0, kind="join", nid=0)):
        with pytest.raises(ValueError) as want:
            RFaultEvent(**bad)
        with pytest.raises(ValueError) as got:
            FaultEvent(**bad)
        assert str(got.value) == str(want.value)
    sched = [FaultEvent(1.0, "leave", 0), FaultEvent(2.0, "leave", 0)]
    with pytest.raises(KeyError, match="inactive node 0"):
        FaultSchedule(sched).validate([0, 1])


# --------------------------------------------------------------- admission
def _pair(backend, use_dur, rng, n=40, caps=(32.0, 48.0, 40.0), K=3, G=16):
    ref = RAdmission(caps, K=K, G=G, backend="numpy", use_dur=use_dur)
    got = AdmissionState(caps, K=K, G=G, backend=backend, use_dur=use_dur,
                         device=CPU)
    lanes = _lanes(rng, n, K, G, use_dur)
    ref.add_lanes(*lanes)
    got.add_lanes(*lanes)
    return ref, got


def _same_columns(ref, got, now, lanes):
    want = ref.columns(now, lanes)
    np.testing.assert_array_equal(got.columns(now, lanes), want)
    np.testing.assert_allclose(got.minresid[:, lanes],
                               ref.minresid[:, lanes], rtol=1e-12, atol=0)


@pytest.mark.parametrize("use_dur", [True, False])
@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_admission_protocol_matches_reference(backend, use_dur):
    """Refresh after every step of the invalidation protocol: placements,
    a release, a re-plan (queued and resident), node join and leave, and
    a clock advance."""
    rng = np.random.default_rng(3)
    ref, got = _pair(backend, use_dur, rng)
    queue = list(range(6, 40))
    for now, (ni, lane) in zip((0.0, 0.0, 4.0, 4.0, 9.0, 9.0),
                               ((0, 0), (1, 1), (2, 2), (0, 3), (1, 4),
                                (2, 5))):
        _same_columns(ref, got, now, queue)
        ref.place(ni, lane, now)
        got.place(ni, lane, now)
    _same_columns(ref, got, 9.0, queue)
    ref.release(0, 3)
    got.release(0, 3)
    _same_columns(ref, got, 9.0, queue)
    new = _lanes(rng, 2, 3, 16, use_dur)
    for lane, row in ((7, 0), (4, 1)):   # queued, then resident
        ref.update_lane(lane, new[0][row], new[1][row], new[2][row])
        got.update_lane(lane, new[0][row], new[1][row], new[2][row])
        _same_columns(ref, got, 9.0, queue)
    assert ref.add_node(64.0) == got.add_node(64.0)
    _same_columns(ref, got, 9.0, queue)
    assert ref.remove_node(1) == got.remove_node(1)
    _same_columns(ref, got, 12.5, queue)
    np.testing.assert_array_equal(got.valid, ref.valid)


@pytest.mark.parametrize("n", [40, 300])
@pytest.mark.parametrize("select", ["first", "headroom"])
@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_drain_matches_reference(backend, select, n):
    """Greedy drains over a resident base: placements exact, in order;
    300 queued lanes take the fused backend's pre-filter path."""
    rng = np.random.default_rng(n)
    use_dur = select == "first"
    caps = (48.0, 64.0, 32.0, 96.0) if n > 100 else (32.0, 48.0, 40.0)
    ref, got = _pair(backend, use_dur, rng, n=n, caps=caps)
    for now, lanes in ((0.0, [0, 1, 2]), (5.0, range(3, n))):
        placed = got.drain(now, list(lanes), select=select)
        assert placed == ref.drain(now, list(lanes), select=select)
        assert got.running == ref.running
        np.testing.assert_array_equal(got.admit_t, ref.admit_t)
    assert len(placed) > 3
    if backend == "fused":
        # one host read per drain iteration, one per pre-filter refresh
        st = got.stats
        assert st["host_reads"] >= st["drain_iterations"] \
            >= st["drain_dispatches"] > 0
        assert torch.equal(got._dadmit[:got.B],
                           torch.from_numpy(got.admit_t))


def test_sharded_drain_needs_a_group_of_shard_ranks():
    """``shard=n`` needs a process group of ``n`` ranks, as the reference
    needs ``n`` devices; ``shard=1`` without one starts a one-rank group
    that ``close`` destroys, and never a caller's."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        AdmissionState([1.0, 2.0], K=1, G=4, shard=2, device=CPU)
    with pytest.raises(ValueError, match="requires backend='fused'"):
        AdmissionState([1.0], K=1, G=4, backend="numpy", shard=1)
    assert not dist.is_initialized()
    with AdmissionState([1.0, 2.0], K=1, G=4, shard=1, device=CPU) as adm:
        assert dist.is_initialized() and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="but the group has 1"):
            AdmissionState([1.0, 2.0], K=1, G=4, shard=2, device=CPU)
        assert adm.stats["collectives"] == 0
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        AdmissionState([1.0], K=1, G=4, shard=1, device=CPU).close()
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [40, 300])
@pytest.mark.parametrize("select", ["first", "headroom"])
def test_one_shard_drain_equals_the_unsharded(select, n):
    """``shard=1`` in one process: the node-sharded program (one placement
    and two or three collectives an iteration) places what the unsharded
    drain and the reference's numpy drain place, decision for decision,
    node churn between drains and a queue past ``DRAIN_CAP`` included."""
    use_dur = select == "first"
    caps = (48.0, 64.0, 32.0, 96.0) if n > 100 else (32.0, 48.0, 40.0)
    lanes = _lanes(np.random.default_rng(n + 7), n, 3, 16, use_dur)
    ref = RAdmission(caps, K=3, G=16, backend="numpy", use_dur=use_dur)
    plain = AdmissionState(caps, K=3, G=16, use_dur=use_dur, device=CPU)
    with AdmissionState(caps, K=3, G=16, use_dur=use_dur, shard=1,
                        device=CPU) as got:
        placed = 0
        cut = n - 20 if n > 100 else n // 2  # 277 lanes: the pre-filter
        steps = ((0.0, [0, 1, 2]), (5.0, range(3, cut)), (9.0, range(cut, n)))
        for adm in (ref, plain, got):
            adm.add_lanes(*lanes)
        for i, (now, queue) in enumerate(steps):
            if i == 2:  # a leave, then a join, before the last drain
                states = (ref, plain, got)
                evicted = [adm.remove_node(1) for adm in states]
                assert evicted[1] == evicted[2] == evicted[0]
                for adm in states:
                    adm.add_node(56.0)
            want = ref.drain(now, list(queue), select=select)
            assert plain.drain(now, list(queue), select=select) == want
            assert got.drain(now, list(queue), select=select) == want
            assert got.running == ref.running
            np.testing.assert_array_equal(got.admit_t, ref.admit_t)
            placed += len(want)
        assert placed > 6
        st = got.stats
        assert st["drain_iterations"] == placed + st["drain_dispatches"]
        assert st["collectives"] == (2 if select == "first" else 3) \
            * st["drain_iterations"]
        assert torch.equal(got._dadmit[:got.B],
                           torch.from_numpy(got.admit_t))


# ----------------------------------------------------------------- cluster
def _multiseg(cls_job, cls_plan, n_jobs=40, seed=0, under_frac=0.25,
              rel=None):
    """The reference suites' seeded multi-node mix: 2-segment plans,
    ``under_frac`` of them under-allocated (retries)."""
    rng = np.random.default_rng(seed)
    jobs = []
    for j in range(n_jobs):
        L = int(rng.integers(24, 90))
        split = int(rng.uniform(0.4, 0.8) * L)
        lo, hi = float(rng.uniform(1.5, 3.0)), float(rng.uniform(5.0, 11.0))
        mem = np.concatenate([np.full(split, lo), np.full(L - split, hi)])
        mem = mem * (1.0 + 0.02 * np.sin(np.arange(L)))
        scale = 0.9 if rng.uniform() < under_frac else 1.12
        plan = cls_plan(starts=np.asarray([0.0, max(split - 2.0, 1.0)]),
                        peaks=np.asarray([lo * 1.15, hi * scale]))
        jobs.append(cls_job(jid=j, family="t" if j % 3 else "u",
                            input_gb=1.0, mem=mem, dt=1.0, plan=plan,
                            est_runtime=float(L),
                            release_time=0.0 if rel is None
                            else float(rel[j])))
    return jobs


def _port_runs(nodes, jobs_fn, retry, faults=None, **kw):
    """The port's engines on one workload: legacy, packed, fused with the
    device drain, the host drain and the numpy admission backend."""
    out = {}
    for name, engine, drain in (("legacy", "legacy", "device"),
                                ("packed", "packed", "device"),
                                ("fused", "fused", "device"),
                                ("fused-host", "fused", "host")):
        sim = ClusterSim(nodes(), engine=engine, drain=drain, device=CPU,
                         **kw)
        out[name] = sim.run(jobs_fn(), retry, faults=faults)
    sim = ClusterSim(nodes(), engine="fused", device=CPU, **kw)
    out["fused-numpy"] = sim._run_fused(
        jobs_fn(), retry, None, None, True, admission_backend="numpy",
        faults=() if faults is None else tuple(faults))
    return out


def _faults(kind, nodes, seed, cls):
    if kind == "none":
        return None
    if kind == "storm":
        return cls.preemption_storm(nodes, t=60.0, frac=0.5, seed=seed,
                                    down_time=120.0)
    if kind == "churn":
        return cls.node_churn(nodes, rate=1 / 120, horizon=900.0,
                              seed=seed, mean_down=90.0)
    return cls.rack_failure(nodes, {n.nid: n.nid % 2 for n in nodes}, 1,
                            t=90.0, down_time=180.0)


CASES = [("workload_replay", "none", "none"),
         ("workload_replay", "poisson", "storm"),
         ("deep_chain", "none", "churn"),
         ("wide_fanout", "poisson", "rack"),
         ("burst_arrival", "none", "storm"),
         ("burst_arrival", "poisson", "churn")]


@pytest.mark.parametrize("scenario,arrival,fault", CASES)
def test_engines_match_reference_on_carried_scenarios(scenario, arrival,
                                                      fault):
    n, seed = 72, 1
    ref_wf = scen_ref.get(scenario, n_tasks=n, seed=seed)
    if arrival == "poisson":
        ref_wf = arr_ref.with_arrivals(ref_wf, arr_ref.poisson_arrivals(
            ref_wf.B, 0.5, seed=seed, parents=ref_wf.parents))
    wf = load_workflow_trace(ref_wf, device=CPU)
    want = RSim(_nodes(RNode), engine="packed").run(
        ref_wf.to_jobs(under_frac=0.2, seed=seed), RSpec("ksplus"),
        faults=_faults(fault, _nodes(RNode), seed, RFaults))
    assert want.retries > 0
    got = _port_runs(_nodes, lambda: wf.to_jobs(under_frac=0.2, seed=seed),
                     RetrySpec("ksplus"),
                     faults=_faults(fault, _nodes(), seed, FaultSchedule))
    for name, res in got.items():
        try:
            _assert_same(res, want)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None


def test_legacy_matches_reference_legacy():
    ref_wf = scen_ref.get("deep_chain", n_tasks=60, seed=2)
    wf = load_workflow_trace(ref_wf, device=CPU)
    faults = [(5.0, "leave", 0), (40.0, "join", 0, 48.0)]
    want = RSim(_nodes(RNode), engine="legacy").run(
        ref_wf.to_jobs(under_frac=0.3, seed=2), r_ksplus_retry,
        faults=[RFaultEvent(*f) for f in faults])
    got = ClusterSim(_nodes(), engine="legacy", device=CPU).run(
        wf.to_jobs(under_frac=0.3, seed=2), ksplus_retry,
        faults=[FaultEvent(*f) for f in faults])
    _assert_same(got, want)
    assert want.evictions > 0


@pytest.mark.parametrize("kind", ["ksplus", "kseg-partial", "double",
                                  "max-machine", "callable"])
def test_retry_rules_match_reference(kind):
    rel = arr_ref.poisson_arrivals(40, 0.3, seed=2)
    want = RSim(_nodes(RNode), engine="packed").run(
        _multiseg(RJob, RPlan, seed=13, under_frac=0.7, rel=rel),
        r_ksplus_retry if kind == "callable" else RSpec(kind))
    got = _port_runs(_nodes, lambda: _multiseg(Job, AllocationPlan, seed=13,
                                               under_frac=0.7, rel=rel),
                     ksplus_retry if kind == "callable" else RetrySpec(kind))
    for name, res in got.items():
        _assert_same(res, want)
    assert want.retries >= 5


@pytest.mark.parametrize("engine", ["packed", "fused"])
def test_offset_sweeps_match_reference(engine):
    ref_wf = scen_ref.get("workload_replay", n_tasks=64, seed=4)
    wf = load_workflow_trace(ref_wf, device=CPU)
    cands = [(0.0, 0.0, None), (0.05, 0.1, 0.3), (-0.02, 0.0, 0.1)]
    want = RSim(_nodes(RNode), engine="packed").run(
        ref_wf.to_jobs(under_frac=0.3, seed=4), RSpec("ksplus"),
        offsets=[ROffset(*c) for c in cands])
    got = ClusterSim(_nodes(), engine=engine, device=CPU).run(
        wf.to_jobs(under_frac=0.3, seed=4), RetrySpec("ksplus"),
        offsets=[OffsetCandidate(*c) for c in cands])
    for g, w in zip(got, want):
        _assert_same(g, w)
    fam = {"etl": (0.05, 0.0, 0.4), "score": (0.0, 0.1, None)}
    want = RSim(_nodes(RNode), engine="packed").run(
        ref_wf.to_jobs(under_frac=0.3, seed=4), RSpec("ksplus"),
        offsets={f: ROffset(*c) for f, c in fam.items()})
    got = ClusterSim(_nodes(), engine=engine, device=CPU).run(
        wf.to_jobs(under_frac=0.3, seed=4), RetrySpec("ksplus"),
        offsets={f: OffsetCandidate(*c) for f, c in fam.items()})
    _assert_same(got, want)
    want = RSim(_nodes(RNode), engine="packed").run(
        ref_wf.to_jobs(under_frac=0.3, seed=4), RSpec("ksplus"),
        offsets="auto")
    got = ClusterSim(_nodes(), engine=engine, device=CPU).run(
        wf.to_jobs(under_frac=0.3, seed=4), RetrySpec("ksplus"),
        offsets="auto")
    _assert_same(got, want)


def test_write_back_matches_reference():
    want_jobs = _multiseg(RJob, RPlan, seed=3, under_frac=0.5)
    got_jobs = _multiseg(Job, AllocationPlan, seed=3, under_frac=0.5)
    RSim(_nodes(RNode), engine="packed").run(want_jobs, RSpec("ksplus"))
    ClusterSim(_nodes(), device=CPU).run(got_jobs, RetrySpec("ksplus"))
    for a, b in zip(got_jobs, want_jobs):
        assert a.attempts == b.attempts
        np.testing.assert_allclose(a.wasted_gbs, b.wasted_gbs, rtol=1e-6)
        np.testing.assert_array_equal(a.plan.starts, b.plan.starts)
        np.testing.assert_array_equal(a.plan.peaks, b.plan.peaks)


def test_one_probe_per_dt_group_and_no_launch_on_the_cpu():
    ref_wf = scen_ref.get("hetero_dt", n_tasks=60, seed=0)
    wf = load_workflow_trace(ref_wf, device=CPU)
    before = dict(ops.LAUNCHES)
    sim = ClusterSim(_nodes(spec=((0, 64.0), (1, 96.0))), device=CPU)
    got = sim.run(wf.to_jobs(under_frac=0.2), RetrySpec("ksplus"))
    assert sim.stats["probe_groups"] == len(set(wf.dts)) == 3
    assert ops.LAUNCHES == before
    want = RSim(_nodes(RNode, ((0, 64.0), (1, 96.0))), engine="packed").run(
        ref_wf.to_jobs(under_frac=0.2), RSpec("ksplus"))
    _assert_same(got, want)


def test_submit_validation_same_errors():
    big = _multiseg(Job, AllocationPlan, n_jobs=3)
    big[1].plan = AllocationPlan(np.zeros(1), np.asarray([500.0]))
    rbig = _multiseg(RJob, RPlan, n_jobs=3)
    rbig[1].plan = RPlan(np.zeros(1), np.asarray([500.0]))
    with pytest.raises(ValueError) as want:
        RSim(_nodes(RNode), engine="packed").run(rbig, RSpec("ksplus"))
    with pytest.raises(ValueError) as got:
        ClusterSim(_nodes(), device=CPU).run(big, RetrySpec("ksplus"))
    assert str(got.value) == str(want.value)
    cyc = _multiseg(Job, AllocationPlan, n_jobs=3)
    cyc[0].parents, cyc[2].parents = (2,), (0,)
    with pytest.raises(ValueError, match="cycle"):
        ClusterSim(_nodes(), device=CPU).run(cyc, RetrySpec("ksplus"))
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        ClusterSim(_nodes(), device=CPU, shard=2).run(
            _multiseg(Job, AllocationPlan, n_jobs=3), RetrySpec("ksplus"))


# ----------------------------------------------------------------- elastic
def _env(rng, peak, cls):
    k = int(rng.integers(1, 4))
    starts = np.sort(np.concatenate([[0.0], rng.uniform(5.0, 200.0, k - 1)]))
    return cls(starts=starts, peaks=np.sort(rng.uniform(peak / 2, peak, k)))


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_elastic_planner_matches_reference(backend):
    """A join/leave churn with a retry storm: every decision the planner
    returns equals the reference numpy planner's."""
    ref = RPlanner(backend="numpy")
    got = ElasticPlanner(backend=backend, device=CPU)
    rng = np.random.default_rng(0)
    now, alive, nxt = 0.0, [], 0
    for name, cap in (("n0", 48.0), ("n1", 32.0)):
        assert got.node_join(name, cap) == ref.node_join(name, cap)
        alive.append(name)
    for step in range(60):
        now += float(rng.uniform(0.0, 5.0))
        op = rng.uniform()
        if op < 0.45:
            seed = int(rng.integers(1 << 30))
            peak = float(rng.uniform(6, 30))
            env = (_env(np.random.default_rng(seed), peak, AllocationPlan),
                   _env(np.random.default_rng(seed), peak, RPlan))
            assert got.submit(f"j{step}", env[0], now) == \
                ref.submit(f"j{step}", env[1], now)
        elif op < 0.6 and ref.queued:
            jid = ref.pending[0][0]
            seed = int(rng.integers(1 << 30))
            got.pending[0] = (jid, _env(np.random.default_rng(seed), 12.0,
                                        AllocationPlan))
            ref.pending[0] = (jid, _env(np.random.default_rng(seed), 12.0,
                                        RPlan))
            assert got.drain(now) == ref.drain(now)
        elif op < 0.7 and any(sl.jobs for sl in ref.slices.values()):
            jid = next(sl.jobs[0][0] for sl in ref.slices.values()
                       if sl.jobs)
            got.finish(jid)
            ref.finish(jid)
        elif op < 0.85:
            name = f"x{nxt}"
            nxt += 1
            alive.append(name)
            cap = float(rng.uniform(24, 64))
            assert got.node_join(name, cap, now=now) == \
                ref.node_join(name, cap, now=now)
        elif len(alive) > 1:
            victim = alive.pop(int(rng.integers(0, len(alive))))
            assert got.node_leave(victim, now=now) == \
                ref.node_leave(victim, now=now)
        assert got.queued == ref.queued
        for name in ref.slices:
            assert [j for j, _, _ in got.slices[name].jobs] == \
                [j for j, _, _ in ref.slices[name].jobs]
            assert got.slices[name].headroom(now) == \
                ref.slices[name].headroom(now)
    assert ref.queued and any(sl.jobs for sl in ref.slices.values())
    with pytest.raises(KeyError, match="unknown slice"):
        got.node_leave("nope")


@pytest.mark.parametrize("n", [1, 6, 12, 16, 48, 96, 128])
def test_plan_mesh_identical(n):
    for div in ((), (8,), (12, 16), (7,)):
        assert plan_mesh(n, div) == plan_mesh_ref(n, div)


def test_monitor_and_footprint_model():
    mon = MemoryMonitor("train", 1.0, dt=0.0)
    mon.sample()
    mon.sample()
    assert len(mon.trace()) == 2 and read_rss_gb() > 0
    rng = np.random.default_rng(0)
    got, ref = HBMFootprintModel(k=3, device=CPU), RFootprint(k=3)
    for tokens in (1e3, 2e3, 4e3, 8e3, 16e3):
        env = np.concatenate([np.full(5, 1 + tokens / 4e3),
                              np.full(10, 2 + tokens / 2e3)])
        env = env * (1 + 0.01 * rng.standard_normal(15))
        got.observe(tokens, env)
        ref.observe(tokens, env)
    a, b = got.fit().predict(6e3), ref.fit().predict(6e3)
    np.testing.assert_allclose(a.starts, b.starts, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.peaks, b.peaks, rtol=1e-5)

