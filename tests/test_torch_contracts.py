"""Runtime dispatch/compile contracts (``repro_torch.analysis.contracts``).

The reference's ``tests/test_contracts.py`` pins three invariants that
differential tests are blind to; the port keeps the ones that mean
something without a JIT and holds them here:

* **budget mechanics** (``TestDispatchBudgetUnit``) — the same scopes give
  the same counts and the same violations as the reference's budget.  The
  port's compiles are its ``nvcc`` builds and library loads, which
  ``kernels/build.py`` reports through ``contracts.record_compile``; they
  never happen on the CPU, so the hook is driven directly, and
  ``build.load`` is driven from two threads with the compiler and the
  loader stubbed;
* **one program per drain** — one ``admission.drain`` dispatch per
  ``_drain_fused`` call, and one host read per drain iteration;
* **zero rebuild on churn** — node join/leave never re-uploads the
  device-resident lane state: ``admission.dev_sync`` fires once per replay;
* **one engine dispatch per fleet call** — ``fleet.engine`` once per
  ``simulate_fleet_many`` call (one ``fleet_engine`` launch on the card);
* **serving** (``TestServeContracts``) — one ``serve.batch`` per bucket
  flush, no build or load on warm traffic, and ``serve.dev_sync`` once per
  (tenant, family, snapshot).

The reference's fused admission cannot run in this environment, so the
port's counts stand alone there; the budget mechanics run through both.
"""

import ctypes
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import contracts as r_contracts
from repro_torch.analysis import contracts
from repro_torch.analysis.contracts import (Budget, DispatchBudgetError,
                                            dispatch_budget, record_dispatch)
from repro_torch.core import AllocationPlan, RetrySpec
from repro_torch.core.fleet import bucket_traces, simulate_fleet_many
from repro_torch.kernels import build
from repro_torch.sched import (AdmissionState, ClusterSim, ElasticPlanner,
                               FaultSchedule, Job, Node)

from test_torch_sched import _multiseg
from torch_cases import _lanes

CPU = "cpu"


# ------------------------------------------------------- budget mechanics
class TestDispatchBudgetUnit:
    def test_compile_counting_and_cache_hits(self):
        """A build and a load count; a scope that builds nothing counts 0
        (the reference counts XLA compiles the same way)."""
        with dispatch_budget() as cold:
            contracts.record_compile("wastage.cu", "build", 1.5)
            contracts.record_compile("wastage.cu", "load", 0.01)
        assert cold.compiles == 2
        with dispatch_budget(compiles=0) as warm:
            record_dispatch("fleet.engine")
        assert warm.compiles == 0

    def test_compile_budget_violation_raises(self):
        with pytest.raises(DispatchBudgetError, match="compiled"):
            with dispatch_budget(compiles=0):
                contracts.record_compile("ssd.cu", "build", 3.0)

    def test_dispatch_tags_and_forbid(self):
        record_dispatch("t.outside")  # before the scope: not counted
        with dispatch_budget(dispatches=3, tags=("t.a",)) as b:
            record_dispatch("t.a", 2)
            record_dispatch("t.b", 5)  # untagged for this budget
        assert b.tag_counts["t.a"] == 2
        assert b.tag_counts["t.b"] == 5
        assert b.dispatches == 2
        with pytest.raises(DispatchBudgetError, match="forbidden"):
            with dispatch_budget(forbid=("t.boom",)):
                record_dispatch("t.boom")

    def test_dispatch_ceiling_violation(self):
        with pytest.raises(DispatchBudgetError, match="launched"):
            with dispatch_budget(dispatches=1):
                record_dispatch("t.c", 2)

    def test_budget_readable_after_exit(self):
        with dispatch_budget() as b:
            record_dispatch("t.after", 4)
        assert isinstance(b, Budget)
        assert b.tag_counts["t.after"] == 4
        assert b.violations() == []

    @pytest.mark.parametrize("case", [
        dict(dispatches=1, tags=None, forbid=(), fire=[("a", 2)]),
        dict(dispatches=3, tags=("a",), forbid=(), fire=[("a", 4),
                                                        ("b", 9)]),
        dict(dispatches=None, tags=None, forbid=("x", "y"),
             fire=[("x", 1), ("y", 3), ("z", 1)]),
        dict(dispatches=10, tags=("a", "b"), forbid=("c",),
             fire=[("a", 1), ("b", 2), ("c", 0)]),
    ], ids=["ceiling", "tagged", "forbid", "clean"])
    def test_same_violations_as_reference(self, case):
        """The same scope over both packages' counters reports the same
        counts and the same violation text."""
        budgets = []
        for mod in (contracts, r_contracts):
            b = mod.Budget(None, case["dispatches"], case["tags"],
                           case["forbid"])
            for tag, n in case["fire"]:
                mod.record_dispatch(tag, n)
            budgets.append(b)
        got, want = budgets
        assert got.tag_counts == want.tag_counts
        assert got.dispatches == want.dispatches
        assert got.violations() == want.violations()


class TestThreadSafeLoad:
    def test_two_threads_build_and_load_once(self, monkeypatch, tmp_path):
        """``build.load`` from two threads at once: one build, one load,
        and one compile counted (the stubbed build reports none)."""
        source = tmp_path / "fake_kernel.cu"
        source.write_text("// not compiled")
        builds, loads = [], []
        gate = threading.Barrier(2)

        def fake_build(src):
            builds.append(src)
            time.sleep(0.05)  # hold the first thread inside the fill
            return tmp_path / "libfake.so", 0.05

        class FakeLib:
            def __getattr__(self, name):
                fn = lambda *a: 0  # noqa: E731
                return fn

        def fake_cdll(path):
            loads.append(path)
            return FakeLib()

        monkeypatch.setattr(build, "build", fake_build)
        monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
        monkeypatch.delitem(build._libs, source, raising=False)
        got, errors = [], []

        def worker():
            try:
                gate.wait(timeout=5)
                got.append(build.load(source, {"ksp_fake": []}))
            except BaseException as exc:  # reported below
                errors.append(exc)

        c0 = contracts.compile_count()
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        try:
            assert not errors
            assert len(builds) == 1 and len(loads) == 1
            assert len(got) == 2 and got[0] is got[1]
            assert contracts.compile_count() - c0 == 1
        finally:
            build._libs.pop(source, None)

    def test_many_threads_stress(self, monkeypatch, tmp_path):
        """More threads than cores race ``load`` and ``record_compile``
        with a short switch interval: still one build and one load, and
        no compile count lost."""
        import sys
        source = tmp_path / "stress.cu"
        source.write_text("// stress")
        builds = []
        monkeypatch.setattr(build, "build", lambda src: builds.append(src)
                            or (tmp_path / "libstress.so", 0.0))
        monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
        monkeypatch.delitem(build._libs, source, raising=False)
        gate = threading.Barrier(32)

        def worker():
            gate.wait(timeout=10)
            build.load(source, {})
            for _ in range(200):
                contracts.record_compile("stress.cu", "load", 0.0)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        c0 = contracts.compile_count()
        try:
            threads = [threading.Thread(target=worker) for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(old)
            build._libs.pop(source, None)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1
        assert contracts.compile_count() - c0 == 1 + 32 * 200

    def test_temporary_file_named_by_thread(self, monkeypatch, tmp_path):
        """Two threads building the same source write two temporary
        files, never one."""
        source = tmp_path / "k.cu"
        source.write_text("// k")
        monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "out")
        monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
        outs = []

        class Proc:
            returncode, stdout, stderr = 0, "", ""

        def fake_run(cmd, **kw):
            out = Path(cmd[cmd.index("-o") + 1])
            outs.append(out.name)
            out.write_bytes(b"lib")
            return Proc()

        monkeypatch.setattr(build.subprocess, "run", fake_run)
        gate = threading.Barrier(2)

        def worker():
            gate.wait(timeout=5)
            build.build(source)

        threads = [threading.Thread(target=worker) for _ in range(2)]
        c0 = contracts.compile_count()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert 1 <= len(outs) <= 2 and len(set(outs)) == len(outs)
        assert contracts.compile_count() - c0 == len(outs)
        assert build._lib_path(source).read_bytes() == b"lib"


# -------------------------------------------------- one program per drain
class TestOneProgramPerDrain:
    @staticmethod
    def _scripted_drains(seed=8, caps=(40.0, 20.0, 36.0)):
        """Admit 14 lanes, drain three times with a release in between."""
        adm = AdmissionState(caps, K=3, G=16, backend="fused",
                             use_dur=True, device=CPU)
        lanes = adm.add_lanes(*_lanes(np.random.default_rng(seed), 14,
                                      adm.K, adm.G, adm.use_dur))
        placed = adm.drain(0.0, lanes)
        if placed:
            ji, ni = placed[0]
            adm.release(ni, ji)
        adm.drain(7.0, lanes)
        adm.drain(40.0, lanes)
        return adm

    @pytest.mark.parametrize("caps", [(40.0, 20.0, 36.0),
                                      (24.0, 64.0, 18.0)])
    def test_one_dispatch_per_drain_no_compiles(self, caps):
        with dispatch_budget(compiles=0) as b:
            adm = self._scripted_drains(caps=caps)
        assert b.tag_counts["admission.drain"] == 3
        assert adm.stats["drain_dispatches"] == adm.stats["drains"] == 3
        # one host read per drain iteration: a queue within DRAIN_CAP
        # goes to the program whole, no refresh round-trip
        assert adm.stats["host_reads"] == adm.stats["drain_iterations"]
        assert b.tag_counts["admission.dev_sync"] == 1

    def test_wide_backlog_prefilter_counts_its_refreshes(self):
        """A backlog wider than DRAIN_CAP first refreshes its columns (one
        ``admission.columns`` dispatch and host read each) and then
        drains the candidates: dispatches stay counted one per program."""
        adm = AdmissionState((48.0, 64.0, 32.0, 96.0), K=3, G=16,
                             backend="fused", use_dur=True, device=CPU)
        lanes = adm.add_lanes(*_lanes(np.random.default_rng(3), 300,
                                      adm.K, adm.G, adm.use_dur))
        assert len(lanes) > adm.DRAIN_CAP
        with dispatch_budget() as b:
            placed = adm.drain(0.0, lanes)
        assert placed
        st = adm.stats
        assert b.tag_counts["admission.drain"] == st["drain_dispatches"]
        assert b.tag_counts["admission.columns"] >= 1
        assert st["host_reads"] == (st["drain_iterations"]
                                    + b.tag_counts["admission.columns"])

    def test_elastic_drain_one_dispatch_per_drain(self):
        def env(rng, peak):
            k = int(rng.integers(1, 4))
            starts = np.sort(np.concatenate(
                [[0.0], rng.uniform(5.0, 200.0, k - 1)]))
            return AllocationPlan(
                starts=starts, peaks=np.sort(rng.uniform(peak / 2, peak, k)))

        rng = np.random.default_rng(0)
        pl = ElasticPlanner(backend="fused", device=CPU)
        pl.node_join("n0", 48.0)
        pl.node_join("n1", 32.0)
        for step in range(12):
            pl.submit(f"j{step}", env(rng, float(rng.uniform(6, 24))),
                      float(step))
        with dispatch_budget(compiles=0) as b:
            pl.drain(20.0)
        st = pl._adm.stats
        assert b.tag_counts["admission.drain"] >= 1
        assert b.tag_counts["admission.drain"] == st["drain_dispatches"]


# --------------------------------------------------- zero rebuild on churn
def _nodes():
    return [Node(0, 48.0), Node(1, 64.0), Node(2, 32.0)]


class TestZeroRebuildOnChurn:
    def test_node_churn_never_resyncs_device_state(self):
        faults = FaultSchedule.node_churn(_nodes(), rate=0.04,
                                          horizon=250.0, seed=5)
        sim = ClusterSim(_nodes(), engine="fused", drain="device",
                         device=CPU)
        with dispatch_budget(compiles=0) as b:
            res = sim.run(_multiseg(Job, AllocationPlan, 48, seed=5,
                                    under_frac=0.4),
                          RetrySpec("ksplus"), faults=faults)
        assert res.evictions > 0  # churn actually happened
        assert b.tag_counts["admission.dev_sync"] == 1
        assert b.tag_counts["admission.drain"] >= res.evictions // 2
        assert b.tag_counts["admission.drain"] == sim.stats["drains"]
        assert sim.stats["host_reads"] == sim.stats["drain_iterations"]
        assert b.tag_counts["cluster.first_attempt"] == 1

    def test_storm_rejoin_no_rebuild(self):
        faults = FaultSchedule.preemption_storm(
            _nodes(), t=30.0, frac=0.9, seed=2, down_time=35.0)
        sim = ClusterSim(_nodes(), engine="fused", drain="device",
                         device=CPU)
        with dispatch_budget(forbid=()) as b:
            res = sim.run(_multiseg(Job, AllocationPlan, 40, seed=3,
                                    under_frac=0.5),
                          RetrySpec("ksplus"), faults=faults)
        assert res.evictions > 0
        assert b.tag_counts["admission.dev_sync"] == 1


# ----------------------------------------- one engine dispatch per fleet call
def test_one_engine_dispatch_per_fleet_call():
    rng = np.random.default_rng(1)
    mems = [rng.uniform(1.0, 4.0, int(n)) for n in rng.integers(10, 300, 40)]
    batch = bucket_traces(mems, device=CPU)
    assert len(batch.buckets) > 1
    jobs = [((np.zeros((40, 1), np.float32),
              np.full((40, 1), p, np.float32), np.ones(40, np.int32)),
             RetrySpec(kind)) for p, kind in ((2.0, "double"),
                                               (3.0, "max-machine"))]
    with dispatch_budget(compiles=0, dispatches=2,
                         tags=("fleet.engine",)) as b:
        simulate_fleet_many(jobs, batch, machine_memory=64.0)
        simulate_fleet_many(jobs[:1], batch, machine_memory=64.0)
    assert b.tag_counts["fleet.engine"] == 2


# ------------------------------------------------------- serving contracts
class TestServeContracts:
    """The serving path's dispatch discipline (see repro_torch.serve):

    * one ``serve.batch`` dispatch per bucket flush,
    * no kernel build or library load on warm traffic,
    * ``serve.dev_sync`` fires once per (tenant, family, snapshot) and
      never again until a refit forks the snapshot,
    * one ``fleet.engine`` dispatch per evaluate bucket and per tune
      candidate group.
    """

    def _warm_server(self, tenants=2):
        from repro_torch.serve.bench import (FAMILIES, build_server,
                                             request_tape)

        srv = build_server(tenants=tenants, batching=True, max_batch=64,
                           seed=0, device=CPU)
        futs = [srv.submit("predict", t, f, x)
                for t, f, x in request_tape(128, tenants, seed=1)]
        srv.drain()
        [f.result(0) for f in futs]
        for t in range(tenants):
            client = srv.client(f"tenant{t}")
            for family, _ in FAMILIES:
                client.evaluate(family)
        srv.client("tenant0").tune_offset("align")
        return srv

    def test_warm_serve_zero_compiles_one_batch_per_bucket(self):
        from repro_torch.serve.bench import FAMILIES, request_tape

        srv = self._warm_server()
        before = srv._batcher.stats["batches"]
        with dispatch_budget(compiles=0,
                             forbid=("serve.dev_sync",)) as warm:
            futs = [srv.submit("predict", t, f, x)
                    for t, f, x in request_tape(96, 2, seed=7)]
            srv.drain()
            [f.result(0) for f in futs]
            for t in range(2):
                client = srv.client(f"tenant{t}")
                for family, _ in FAMILIES:
                    client.evaluate(family)
            srv.client("tenant0").tune_offset("align")
        flushed_buckets = srv._batcher.stats["batches"] - before
        # exactly one serve.batch dispatch per bucket flush, nothing else
        assert warm.tag_counts["serve.batch"] == flushed_buckets
        assert warm.compiles == 0
        # one engine dispatch per evaluate (2 tenants x 4 families) and
        # one for the tune group
        assert warm.tag_counts["fleet.engine"] == 2 * len(FAMILIES) + 1

    def test_dev_sync_once_per_snapshot_then_refit_scoped(self):
        from repro_torch.core.predictor import ExecutionOutcome
        from repro_torch.serve.bench import build_server

        srv = build_server(tenants=2, batching=True, seed=0, device=CPU)
        client = srv.client("tenant0")
        with dispatch_budget() as b:
            client.evaluate("align")
            client.evaluate("align")          # warm: resident traces
            srv.client("tenant1").evaluate("align")  # own (tenant, sid) key
        assert b.tag_counts["serve.dev_sync"] == 2
        client.observe("align", ExecutionOutcome(
            mem=np.full(40, 9.0), dt=1.0, input_gb=3.0, succeeded=True))
        assert client.refit("align")
        with dispatch_budget() as after:
            client.evaluate("align")          # forked sid: one new upload
            client.evaluate("align")
            srv.client("tenant1").evaluate("align")  # old sid: still warm
        assert after.tag_counts["serve.dev_sync"] == 1

    def test_cache_hit_tag_fires_on_submit_fast_path(self):
        from repro_torch.serve.bench import build_server

        srv = build_server(tenants=1, batching=True, seed=0, device=CPU)
        client = srv.client("tenant0")
        client.predict("align", 2.0)
        with dispatch_budget() as b:
            assert client.predict("align", 2.0) is not None
        assert b.tag_counts["serve.cache_hit"] == 1
        assert b.tag_counts.get("serve.batch", 0) == 0  # no dispatch at all
