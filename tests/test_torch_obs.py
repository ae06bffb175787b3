"""repro_torch.obs: tracer, metrics registry, exporters, and the
zero-perturbation contract, against the reference's ``repro.obs``.

The tracing contract under test (the reference's ``tests/test_obs.py``,
held against the port): with observability off, instrumented hot paths
record *nothing*; with it on, spans/instants/dispatch tags land in the
bounded ring and metrics in the global registry — and a traced replay
stays **bitwise identical** to an untraced one on every decision log
(placements, retries, evictions) and on served plans.  Exporters must
round-trip, and give the reference's output on the same events (apart
from the name of a compile: ``kernels.build`` here, ``jax.compile``
there).  The port's compiles are its kernel builds and library loads,
which ``kernels/build.py`` reports through ``contracts.record_compile``;
they never fire on the CPU, so the compile bridge is driven directly.

The reference's fused replay cannot run in this environment, so the
port's traced fused replays are held against its own untraced ones, under
churn and under a storm with rejoin.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as r_obs
from repro_torch import obs
from repro_torch.analysis import contracts
from repro_torch.core import AllocationPlan, RetrySpec
from repro_torch.core.fleet import bucket_traces, simulate_fleet_many
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.sched import ClusterSim, FaultSchedule, Job, Node
from repro_torch.workloads import load_workflow_trace, scenarios

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends disabled with an empty default-size
    ring and an empty registry (``enable(ring=N)`` resizes the module
    ring, so tests that shrink it must not leak that into the next)."""

    def reset():
        obs.disable()
        if obs.trace._ring.maxlen != obs.trace.DEFAULT_RING:
            obs.trace._ring = type(obs.trace._ring)(
                maxlen=obs.trace.DEFAULT_RING)
        obs.clear()
        obs.REGISTRY.clear()

    reset()
    yield
    reset()


# -------------------------------------------------------------------- tracer
class TestTracer:
    def test_disabled_records_nothing(self):
        with obs.span("a", x=1) as sp:
            sp.add(y=2)
        obs.instant("b")
        obs.count("weights.cast_bytes", 8)
        contracts.record_dispatch("some.tag")
        contracts.record_compile("wastage.cu", "build", 0.5)
        assert obs.events() == []

    def test_span_event_shape(self):
        with obs.tracing():
            with obs.span("admission.drain", q=3) as sp:
                sp.add(placed=2)
        (ev,) = obs.events()
        assert ev["ph"] == "X" and ev["name"] == "admission.drain"
        assert ev["dur"] >= 0.0 and ev["ts"] >= 0.0
        assert ev["args"] == {"q": 3, "placed": 2}
        assert ev["tid"] == threading.get_ident()

    def test_nesting_orders_inner_first(self):
        with obs.tracing():
            with obs.span("outer"):
                with obs.span("inner"):
                    pass
        names = [e["name"] for e in obs.events()]
        assert names == ["inner", "outer"]

    def test_thread_local_stacks(self):
        """Concurrent spans on two threads never cross-attribute."""
        with obs.tracing():
            barrier = threading.Barrier(2)

            def worker(name):
                with obs.span(name):
                    barrier.wait(timeout=5)
                    contracts.record_dispatch(f"tag.{name}")
                    barrier.wait(timeout=5)

            t = threading.Thread(target=worker, args=("t1",))
            t.start()
            worker("t0")
            t.join(timeout=10)
            assert not t.is_alive()
        by_name = {e["name"]: e for e in obs.events()}
        assert by_name["t0"]["dispatches"] == {"tag.t0": 1}
        assert by_name["t1"]["dispatches"] == {"tag.t1": 1}
        assert by_name["t0"]["tid"] != by_name["t1"]["tid"]

    def test_ring_is_bounded(self):
        with obs.tracing(ring=16):
            for i in range(100):
                obs.instant("e", i=i)
        evs = obs.events()
        assert len(evs) == 16
        assert evs[-1]["args"] == {"i": 99}  # newest survive

    def test_ring_counts_what_it_drops(self):
        with obs.tracing(ring=16):
            for i in range(10):
                obs.instant("e", i=i)
            assert obs.dropped() == 0
            for i in range(90):
                with obs.span("s"):
                    pass
        assert obs.dropped() == 84 and len(obs.events()) == 16
        obs.clear()
        assert obs.dropped() == 0

    def test_span_ids_parents_and_roots(self):
        """Each span names the span that opened it and the outermost one;
        every span under one root shares its id."""
        with obs.tracing():
            with obs.span("step"):
                with obs.span("attention"):
                    with obs.span("inner"):
                        pass
                with obs.span("moe.route"):
                    pass
            with obs.span("next_step"):
                pass
        by = {e["name"]: e for e in obs.events()}
        step = by["step"]
        assert step["parent"] is None and step["root"] == step["id"]
        assert by["attention"]["parent"] == step["id"]
        assert by["inner"]["parent"] == by["attention"]["id"]
        assert by["moe.route"]["parent"] == step["id"]
        assert {by[n]["root"] for n in ("attention", "inner", "moe.route")} \
            == {step["id"]}
        nxt = by["next_step"]
        assert nxt["parent"] is None and nxt["root"] == nxt["id"]
        assert len({e["id"] for e in by.values()}) == 5

    def test_counts_attach_to_the_innermost_span(self):
        with obs.tracing():
            with obs.span("outer"):
                obs.count("weights.cast_bytes", 5)
                with obs.span("inner"):
                    obs.count("weights.cast_bytes", 2)
                    obs.count("weights.cast_bytes", 3)
                    obs.count("other", 1)
            obs.count("weights.cast_bytes", 7)
        by = {e["name"]: e for e in obs.events()}
        assert by["inner"]["counts"] == {"weights.cast_bytes": 5, "other": 1}
        assert by["outer"]["counts"] == {"weights.cast_bytes": 5}
        loose = by["count:weights.cast_bytes"]
        assert loose["ph"] == "i" and loose["args"] == {"n": 7}

    def test_clock_offset_puts_spans_on_the_unix_clock(self):
        with obs.tracing():
            wall_us = time.time_ns() / 1e3
            with obs.span("s"):
                pass
        (ev,) = obs.events()
        assert abs(ev["ts"] + obs.clock_offset_us() - wall_us) < 1000.0

    def test_tracing_restores_prior_state(self):
        with obs.tracing():
            with obs.tracing():
                assert obs.trace.enabled
            assert obs.trace.enabled  # inner exit keeps outer's on
        assert not obs.trace.enabled

    def test_dispatch_attributed_to_open_span(self):
        with obs.tracing():
            with obs.span("work"):
                contracts.record_dispatch("fused.drain", 2)
                contracts.record_dispatch("fused.drain")
        (ev,) = obs.events()
        assert ev["dispatches"] == {"fused.drain": 3}

    def test_dispatch_without_span_is_loose_instant(self):
        with obs.tracing():
            contracts.record_dispatch("fused.drain")
        (ev,) = obs.events()
        assert ev["ph"] == "i" and ev["name"] == "dispatch:fused.drain"

    def test_disable_removes_dispatch_hook(self):
        with obs.tracing():
            assert contracts._obs_dispatch_hook is not None
            assert contracts._obs_compile_hook is not None
        assert contracts._obs_dispatch_hook is None
        assert contracts._obs_compile_hook is None
        contracts.record_dispatch("late.tag")
        assert obs.events() == []

    def test_compile_attributed_to_open_span(self):
        """A kernel build or library load inside a span counts there."""
        with obs.tracing():
            with obs.span("fleet.simulate_many"):
                contracts.record_compile("wastage.cu", "build", 0.25)
                contracts.record_compile("wastage.cu", "load", 0.001)
        (ev,) = obs.events()
        assert ev["compiles"] == 2
        assert ev["compile_us"] == pytest.approx(251000.0)

    def test_loose_compile_is_kernels_build_instant(self):
        with obs.tracing():
            contracts.record_compile("ssd.cu", "build", 2.0)
        (ev,) = obs.events()
        assert ev["ph"] == "i" and ev["name"] == "kernels.build"
        assert ev["args"] == {"duration_us": 2e6, "source": "ssd.cu",
                              "event": "build"}
        assert "kernels.build" in obs.summarize()


# ------------------------------------------------------------------- metrics
class TestMetrics:
    def test_counter_labels(self):
        c = obs.counter("serve.requests")
        c.inc(kind="predict")
        c.inc(2, kind="predict")
        c.inc(kind="evaluate")
        assert c.value(kind="predict") == 3
        assert c.value(kind="evaluate") == 1
        assert c.value(kind="absent") == 0

    def test_gauge_last_write_wins(self):
        g = obs.gauge("serve.queue_depth")
        g.set(5)
        g.set(2)
        assert g.value() == 2.0

    def test_histogram_buckets_cumulative(self):
        h = obs.hist("lat", buckets=(1.0, 10.0, 100.0))
        for v in (0.5, 0.7, 5.0, 1000.0):
            h.observe(v)
        assert h.count() == 4
        (row,) = h.snapshot()["values"]
        assert row["cumulative"] == [2, 3, 3, 4]  # last == count
        assert row["sum"] == pytest.approx(1006.2)

    def test_histogram_rejects_infinite_buckets(self):
        with pytest.raises(ValueError):
            obs.REGISTRY.hist("bad", buckets=(1.0, float("inf")))

    def test_series_bounded_sim_time(self):
        s = obs.REGISTRY.series("curve", maxlen=4)
        for t in range(10):
            s.append(float(t), t * 2.0)
        assert s.points() == [(6.0, 12.0), (7.0, 14.0),
                              (8.0, 16.0), (9.0, 18.0)]

    def test_registry_kind_conflict_is_loud(self):
        obs.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            obs.gauge("x")

    def test_get_or_create_returns_same_object(self):
        assert obs.counter("c") is obs.counter("c")


# ------------------------------------------------------------------- export
def _sample_ring():
    with obs.tracing():
        with obs.span("cluster.run", jobs=3) as sp:
            contracts.record_dispatch("admission.scatter", 2)
            sp.add(retries=1)
        obs.instant("cluster.event_batch", t=1.5, n=4)


class TestExport:
    def test_chrome_trace_round_trip(self, tmp_path):
        _sample_ring()
        path = tmp_path / "trace.perfetto.json"
        n = obs.write_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        assert doc["displayTimeUnit"] == "ms"
        assert len(doc["traceEvents"]) == n == 2
        assert all(ev["pid"] == os.getpid() for ev in doc["traceEvents"])
        back = obs.read_events(str(path))
        assert len(back) == 2
        assert back[0]["dispatches"] == {"admission.scatter": 2}

    def test_chrome_trace_carries_counts_and_the_span_tree(self, tmp_path):
        with obs.tracing():
            with obs.span("model.decode_step"):
                with obs.span("moe.experts"):
                    obs.count("weights.cast_bytes", 64)
        ring = obs.events()
        path = tmp_path / "trace.perfetto.json"
        obs.write_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        inner = doc["traceEvents"][0]["args"]
        assert inner["counts"] == {"weights.cast_bytes": 64}
        assert inner["parent"] == inner["root"] == ring[1]["id"]
        assert obs.read_events(str(path)) == [
            dict(ev, pid=os.getpid(), cat="repro") for ev in ring]

    def test_jsonl_round_trip(self, tmp_path):
        _sample_ring()
        path = tmp_path / "trace.jsonl"
        n = obs.write_jsonl(str(path))
        back = obs.read_events(str(path))
        assert len(back) == n == 2
        assert [e["name"] for e in back] == [e["name"] for e in obs.events()]

    def test_summarize_reports_span_table(self):
        _sample_ring()
        text = obs.summarize()
        assert "cluster.run" in text
        assert "cluster.event_batch" in text  # loose instants section

    def test_summarize_cli(self, tmp_path, capsys):
        _sample_ring()
        path = tmp_path / "t.jsonl"
        obs.write_jsonl(str(path))
        assert obs_cli(["summarize", str(path)]) == 0
        assert "cluster.run" in capsys.readouterr().out

    def test_prometheus_text_shape(self):
        obs.counter("serve.requests").inc(3, kind="predict")
        obs.gauge("serve.queue_depth").set(7)
        h = obs.hist("serve.wait_s", buckets=(0.001, 0.01))
        h.observe(0.005)
        text = obs.prometheus_text()
        lines = text.splitlines()
        assert 'serve_requests{kind="predict"} 3' in lines
        assert "serve_queue_depth 7" in lines
        assert "# TYPE serve_wait_s histogram" in lines
        assert 'serve_wait_s_bucket{le="+Inf"} 1' in lines
        assert "serve_wait_s_count 1" in lines
        # dotted metric names sanitized for the exposition format
        assert "serve.requests" not in text

    def test_metrics_snapshot_json(self, tmp_path):
        obs.counter("c").inc()
        obs.REGISTRY.series("s").append(0.0, 1.0)
        path = tmp_path / "m.json"
        obs.write_metrics_snapshot(str(path))
        snap = json.loads(path.read_text())
        assert snap["c"]["kind"] == "counter"
        assert snap["s"]["points"] == [[0.0, 1.0]]


# ------------------------------------------- exporters against the reference
def _events(compile_name):
    """A fixed event log: nested spans with dispatches and compiles, named
    and dispatch instants, and one compile outside any span, named as
    ``compile_name`` (each package's own compile event)."""
    return [
        {"ph": "X", "name": "admission.drain", "ts": 10.0, "dur": 5.5,
         "tid": 1, "args": {"q": 3, "placed": 2},
         "dispatches": {"admission.drain": 1, "admission.dev_sync": 1}},
        {"ph": "X", "name": "cluster.run", "ts": 2.0, "dur": 40.25,
         "tid": 1, "args": {"engine": "fused"},
         "dispatches": {"cluster.first_attempt": 1}, "compiles": 2,
         "compile_us": 1234.5},
        {"ph": "X", "name": "admission.drain", "ts": 20.0, "dur": 1.5,
         "tid": 1, "dispatches": {"admission.drain": 1}},
        {"ph": "i", "name": "cluster.event_batch", "ts": 12.0, "tid": 1,
         "s": "t", "args": {"t": 3.0, "n": 2}},
        {"ph": "i", "name": "dispatch:serve.cache_hit", "ts": 50.0,
         "tid": 2, "s": "t"},
        {"ph": "i", "name": compile_name, "ts": 60.0, "tid": 2, "s": "t",
         "args": {"duration_us": 99.0}},
    ]


def _fill(registry):
    registry.counter("serve.requests", help="requests").inc(
        3, kind="predict", cache="miss")
    registry.counter("serve.requests").inc(kind="evaluate", cache="miss")
    registry.gauge("serve.queue_depth").set(7)
    h = registry.hist("serve.batch_size", buckets=(1, 4, 16))
    for v in (1, 3, 9, 40):
        h.observe(v)
    s = registry.series("cluster.utilization")
    s.append(0.0, 0.25)
    s.append(4.5, 0.75)
    return registry


class TestExportMatchesReference:
    def test_chrome_trace_same_events(self):
        got = obs.chrome_trace(_events("kernels.build"))
        want = r_obs.chrome_trace(_events("jax.compile"))
        assert got["traceEvents"][-1]["name"] == "kernels.build"
        got["traceEvents"][-1]["name"] = "jax.compile"
        assert got == want

    def test_summarize_same_events(self):
        got = obs.summarize(_events("kernels.build"))
        want = r_obs.summarize(_events("jax.compile"))
        assert re.search(r"^  kernels\.build +1$", got, re.M)
        assert re.sub(r"^  kernels\.build +", "  COMPILES ", got,
                      flags=re.M) == re.sub(r"^  jax\.compile +",
                                            "  COMPILES ", want, flags=re.M)
        assert len(got.splitlines()) == len(want.splitlines())

    def test_prometheus_text_same_registry(self):
        got = obs.prometheus_text(_fill(obs.Registry()))
        want = r_obs.prometheus_text(_fill(r_obs.Registry()))
        assert got == want
        assert (_fill(obs.Registry()).snapshot()
                == _fill(r_obs.Registry()).snapshot())

    def test_read_events_round_trip_same(self, tmp_path):
        evs = _events("kernels.build")
        a, b = tmp_path / "a.json", tmp_path / "b.json"
        obs.write_chrome_trace(str(a), evs)
        r_obs.write_chrome_trace(str(b), evs)
        assert obs.read_events(str(a)) == r_obs.read_events(str(b))


# ------------------------------------------------- zero-perturbation contract
def _nodes():
    return [Node(0, 48.0), Node(1, 64.0), Node(2, 32.0)]


def _workload(n_jobs=30, seed=0):
    rng = np.random.default_rng(seed)
    jobs = []
    for j in range(n_jobs):
        L = int(rng.integers(24, 60))
        split = int(rng.uniform(0.4, 0.8) * L)
        lo = float(rng.uniform(1.5, 3.0))
        hi = float(rng.uniform(5.0, 11.0))
        mem = np.concatenate([np.full(split, lo), np.full(L - split, hi)])
        under = rng.uniform() < 0.25
        plan = AllocationPlan(
            starts=np.asarray([0.0, max(split - 2.0, 1.0)]),
            peaks=np.asarray([lo * 1.15, hi * (0.9 if under else 1.12)]))
        jobs.append(Job(jid=j, family="t", input_gb=1.0, mem=mem, dt=1.0,
                        plan=plan, est_runtime=float(L)))
    return jobs


def _same_replay(traced, base):
    assert traced.placements == base.placements
    assert traced.retries == base.retries
    assert traced.evictions == base.evictions
    assert traced.starved == base.starved
    assert traced.doomed == base.doomed
    assert traced.total_wastage_gbs == base.total_wastage_gbs


FAULTS = {
    "churn": lambda: FaultSchedule.node_churn(
        _nodes(), rate=1.0 / 120.0, horizon=600.0, seed=0, mean_down=60.0),
    "storm_rejoin": lambda: FaultSchedule.preemption_storm(
        _nodes(), t=30.0, frac=0.9, seed=2, down_time=35.0),
}


class TestZeroPerturbation:
    @pytest.mark.parametrize("fault", list(FAULTS))
    def test_traced_replay_bitwise(self, fault):
        base_sim = ClusterSim(_nodes(), engine="fused", device=CPU)
        base = base_sim.run(_workload(), RetrySpec("ksplus"),
                            faults=FAULTS[fault]())
        assert base.evictions > 0  # the faults actually hit
        assert obs.events() == []  # untraced run records nothing
        sim = ClusterSim(_nodes(), engine="fused", device=CPU)
        traced = sim.run(_workload(), RetrySpec("ksplus"),
                         faults=FAULTS[fault](), trace=True)
        _same_replay(traced, base)
        assert sim.stats == base_sim.stats
        assert not obs.trace.enabled  # trace=True is scoped to the run
        evs = obs.events()
        names = {e["name"] for e in evs}
        assert "cluster.run" in names and "admission.drain" in names
        # one admission.drain span per drain, each absorbing its one
        # drain dispatch; churn re-uploads nothing after the first sync
        drains = [e for e in evs if e["name"] == "admission.drain"]
        assert len(drains) == sim.stats["drains"]
        assert sum(e.get("dispatches", {}).get("admission.drain", 0)
                   for e in drains) == sim.stats["drain_dispatches"]
        assert sum(e.get("dispatches", {}).get("admission.dev_sync", 0)
                   for e in evs if e["ph"] == "X") == 1
        # the engine series landed, keyed by sim time, one point per batch
        batches = sum(e["name"] == "cluster.event_batch" for e in evs)
        assert len(obs.REGISTRY.series("cluster.utilization")) == batches > 0
        assert obs.REGISTRY.hist("admission.drain.lanes").count() \
            == sim.stats["drains"]

    def test_traced_run_inside_enabled_scope_not_double_disabled(self):
        jobs = _workload(n_jobs=8)
        with obs.tracing():
            ClusterSim(_nodes(), engine="fused", device=CPU).run(
                jobs, RetrySpec("ksplus"), trace=True)
            assert obs.trace.enabled  # outer scope's switch survives

    def test_traced_scenario_replay_bitwise(self):
        """A carried reference scenario (DAG, retries): traced == untraced
        on the fused engine, and one host read per drain iteration."""
        from repro.workloads import scenarios as scen_ref
        wf = load_workflow_trace(scen_ref.get("workload_replay",
                                              n_tasks=120, seed=0),
                                 device=CPU)
        nodes = lambda: [Node(0, 48.0), Node(1, 64.0)]  # noqa: E731
        base = ClusterSim(nodes(), engine="fused", device=CPU).run(
            wf.to_jobs(under_frac=0.2, seed=0), RetrySpec("ksplus"))
        sim = ClusterSim(nodes(), engine="fused", device=CPU)
        traced = sim.run(wf.to_jobs(under_frac=0.2, seed=0),
                         RetrySpec("ksplus"), trace=True)
        _same_replay(traced, base)
        assert traced.retries > 0
        assert sim.stats["host_reads"] == sim.stats["drain_iterations"]
        (first,) = [e for e in obs.events() if e["name"] == "cluster.run"]
        assert first["dispatches"]["cluster.first_attempt"] == 1

    def test_traced_fleet_call_spans_one_engine_dispatch(self):
        rng = np.random.default_rng(0)
        mems = [rng.uniform(1.0, 4.0, int(n)) for n in
                rng.integers(20, 200, 24)]
        batch = bucket_traces(mems, device=CPU)
        plans = (np.zeros((24, 1), np.float32),
                 np.full((24, 1), 3.0, np.float32), np.ones(24, np.int32))
        base = simulate_fleet_many([(plans, RetrySpec("double"))], batch)
        with obs.tracing():
            traced = simulate_fleet_many([(plans, RetrySpec("double"))],
                                         batch)
        np.testing.assert_array_equal(traced[0].attempts, base[0].attempts)
        np.testing.assert_array_equal(traced[0].wastage_gbs,
                                      base[0].wastage_gbs)
        (ev,) = obs.events()
        assert ev["name"] == "fleet.simulate_many"
        assert ev["dispatches"] == {"fleet.engine": 1}

    def test_traced_suite_case_spans(self):
        from repro_torch.workloads import make_suite, run_suite
        cases = make_suite(("deep_chain",), ("none",), ("storm",))
        base = run_suite(cases, n_tasks=24, device=CPU)
        with obs.tracing():
            traced = run_suite(cases, n_tasks=24, device=CPU)
        assert traced == base
        spans = [e for e in obs.events() if e["name"] == "suite.case"]
        assert [e["args"]["case"] for e in spans] == [c.name for c in cases]

    def test_traced_serve_plans_bitwise(self):
        from repro_torch.serve.bench import (_run_tape, build_server,
                                             request_tape)

        tape = request_tape(64, tenants=2, seed=3, repeat_pool=16)

        def plans(traced):
            clock = [0.0]
            srv = build_server(tenants=2, clock=lambda: clock[0],
                               device=CPU)
            if traced:
                with obs.tracing():
                    return _run_tape(srv, tape)
            return _run_tape(srv, tape)

        base, traced = plans(False), plans(True)
        assert len(base) == len(traced) == 64
        for a, b in zip(base, traced):
            np.testing.assert_array_equal(a.starts, b.starts)
            np.testing.assert_array_equal(a.peaks, b.peaks)
        assert obs.counter("serve.requests").value(
            kind="predict", cache="miss") > 0


def test_scenario_replay_span_table_on_the_cpu():
    """The table ``chip_smoke.py`` prints for the 400-task replay, at a
    small size: spans, their dispatches and the event-batch instants."""
    wf = scenarios.get("workload_replay", n_tasks=64, seed=0, device=CPU)
    sim = ClusterSim(_nodes(), engine="fused", device=CPU)
    sim.run(wf.to_jobs(under_frac=0.2, seed=0), RetrySpec("ksplus"),
            trace=True)
    text = obs.summarize()
    assert re.search(rf"^admission\.drain +{sim.stats['drains']} ", text,
                     re.M)
    assert re.search(r"^cluster\.run +1 ", text, re.M)
    assert "cluster.event_batch" in text


# ------------------------------------------------- the LM serving path's spans
def _olmoe():
    """The olmoe family at smoke size: bf16 compute over float32 masters,
    so every parameter cast at its use changes dtype."""
    from repro_torch import configs
    from repro_torch.models import init_params
    cfg = configs.smoke_config("olmoe-1b-7b")
    assert (cfg.dtype, cfg.param_dtype) == ("bfloat16", "float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)


# the parameters cast to the compute dtype at every use
CAST = ("wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down", "head")


class TestServingSpans:
    def _serve(self, cfg, model, traced):
        """A prefill and one decode step: ``(logits, cache)`` of each."""
        from repro_torch.models import decode_step, prefill
        toks = torch.randint(0, cfg.vocab, (2, 12),
                             generator=torch.Generator().manual_seed(1))
        pos = torch.full((2,), 12, dtype=torch.int32)

        def run():
            lp, cache = prefill(model, cfg, {"tokens": toks}, capacity=16)
            first = {k: v.clone() for k, v in cache.items()}
            ld, cache = decode_step(model, cfg, {"tokens": toks[:, -1]},
                                    cache, pos)
            return (lp, first), (ld, cache)

        if traced:
            with obs.tracing():
                return run()
        return run()

    def test_decode_step_spans_and_casts(self):
        cfg, model = _olmoe()
        self._serve(cfg, model, traced=True)
        evs = [e for e in obs.events() if e["ph"] == "X"]
        L = cfg.n_layers
        want = sum(p.numel() for n, p in model.named_parameters()
                   if n.rsplit(".", 1)[-1] in CAST) * 2   # bf16 bytes
        (root,) = [e for e in evs if e["name"] == "model.decode_step"]
        assert root["parent"] is None and root["args"] == {"B": 2}
        under = [e for e in evs if e["root"] == root["id"]]
        names = [e["name"] for e in under]
        assert names.count("attention") == L
        for part in ("route", "dispatch", "experts", "combine"):
            assert names.count(f"moe.{part}") == L
        assert len(under) == 1 + 5 * L
        # the attention and moe spans are the root's children, and the
        # four moe spans of a block follow one another
        assert all(e["parent"] == root["id"] for e in under if e is not root)
        moe = sorted((e for e in under if e["name"].startswith("moe.")),
                     key=lambda e: e["ts"])
        for a, b in zip(moe, moe[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        assert sum(e.get("counts", {}).get("weights.cast_bytes", 0)
                   for e in under) == want
        # the prefill has no span of its own: its blocks' spans are roots,
        # and the head's cast, outside them, a loose count
        pre = [e for e in evs if e["root"] != root["id"]]
        assert all(e["parent"] is None and e["root"] == e["id"] for e in pre)
        assert sorted(e["name"] for e in pre) == sorted(
            ["attention"] * L + [f"moe.{p}" for p in
                                 ("route", "dispatch", "experts",
                                  "combine")] * L)
        loose = [e["args"]["n"] for e in obs.events()
                 if e["name"] == "count:weights.cast_bytes"]
        assert sum(e.get("counts", {}).get("weights.cast_bytes", 0)
                   for e in pre) + sum(loose) == want
        assert len(loose) == 1          # the head

    def test_traced_serving_is_bitwise_untraced(self):
        cfg, model = _olmoe()
        base = self._serve(cfg, model, traced=False)
        assert obs.events() == []
        traced = self._serve(cfg, model, traced=True)
        for (lb, cb), (lt, ct) in zip(base, traced):
            assert torch.equal(lb, lt)
            assert set(cb) == set(ct)
            for k in cb:
                assert torch.equal(cb[k], ct[k]), k


def _zamba2():
    """Zamba2's own form at a small size, bf16 over float32 masters: three
    uses of two shared blocks before Mamba2 layers 2, 4 and 5 of 6."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import init_params
    cfg = dataclasses.replace(
        configs.get_config("zamba2-2.7b-zyphra"), n_layers=6, d_model=64,
        d_ff=96, vocab=128, n_heads=4, n_kv_heads=4, head_dim=32,
        ssm_state=16, ssm_headdim=16, ssm_chunk=16,
        hybrid_layer_ids=(2, 4, 5), num_mem_blocks=2, adapter_rank=4)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)


class TestZamba2Spans:
    def test_shared_uses_mamba_layers_and_state_bytes(self):
        from repro_torch.models import decode_step, prefill
        from repro_torch.models.blocks import STATE_BYTES
        cfg, model = _zamba2()
        toks = torch.randint(0, cfg.vocab, (2, 12),
                             generator=torch.Generator().manual_seed(1))
        pos = torch.full((2,), 12, dtype=torch.int32)
        base, _ = prefill(model, cfg, {"tokens": toks}, capacity=16)
        assert obs.events() == []              # the tracer off: nothing
        with obs.tracing():
            lp, cache = prefill(model, cfg, {"tokens": toks}, capacity=16)
            decode_step(model, cfg, {"tokens": toks[:, -1]}, cache, pos)
        assert torch.equal(lp, base)
        evs = [e for e in obs.events() if e["ph"] == "X"]
        (root,) = [e for e in evs if e["name"] == "model.decode_step"]
        state = sum(cache[k].numel() * cache[k].element_size()
                    for k in ("ssm", "conv"))
        per_use = {}
        for u in range(3):
            ws = [getattr(model.shared[u % 2].attn, n)
                  for n in ("wq", "wk", "wv", "wo")] \
                + [getattr(model.shared[u % 2].mlp, n)
                   for n in ("w_gate", "w_up", "w_down")] \
                + list(model.uses[u].parameters())
            per_use[u] = 2 * sum(w.numel() for w in ws)      # bf16 bytes
        for decode in (False, True):
            group = [e for e in evs if (e["root"] == root["id"]) == decode]
            shared = [e for e in group if e["name"] == "hybrid.shared"]
            assert [(e["args"]["use"], e["args"]["block"]) for e in shared] \
                == [(0, 0), (1, 1), (2, 0)]
            for e in shared:
                kids = [k for k in evs if k["parent"] == e["id"]]
                assert [k["name"] for k in kids] == ["attention",
                                                     "hybrid.mlp"]
                casts = sum(x.get("counts", {}).get("weights.cast_bytes", 0)
                            for x in kids + [e])
                assert casts == per_use[e["args"]["use"]]
            mamba = [e for e in group if e["name"] == "mamba"]
            assert len(mamba) == cfg.n_layers
            got = sum(e["counts"][STATE_BYTES] for e in mamba)
            # prefill writes each layer's states; a decode step reads
            # and writes them
            assert got == (2 if decode else 1) * state
