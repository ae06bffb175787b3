"""repro_torch.serve: batcher invariants, tenant state, caches, dispatch
parity — the reference's ``tests/test_serve.py`` held against the port,
then the port held against the reference on the same seeded inputs.

The serving contract under test: batched responses are **bitwise equal**
to per-request dispatch across mixed-tenant mixed-family traffic, tenant
refits fork copy-on-write snapshots without perturbing other tenants, and
caches invalidate exactly at refit scope.  Against the reference: served
plans within rtol/atol 1e-5 (the port fits in float32 with its own
reductions: the fit tolerance of ``tests/test_torch_methods.py``),
``evaluate`` with ``succeeded`` and ``mean_attempts`` exact and
``total_gbs`` within rtol 1e-4, ``tune_offset`` with the same best
candidate and totals within rtol 1e-4, and ``serve_demo`` admitting the
same batches.  Every server here runs on the CPU (``device="cpu"``);
``tests/test_torch_serve_card.py`` holds the server on the card against it.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.serve import PredictionServer as RServer
from repro.serve import bench as r_bench
from repro_torch.core import registry
from repro_torch.core.fleet import packed_predict, simulate_fleet_many
from repro_torch.core.predictor import ExecutionOutcome
from repro_torch.core.registry import MissingCapabilityError
from repro_torch.serve import (
    Backpressure,
    MicroBatcher,
    PredictionCache,
    PredictionServer,
    ProgramCache,
    ServeRequest,
    ServerClosed,
    TenantRegistry,
    UnknownFamilyError,
    UnknownTenantError,
)
from repro_torch.serve.bench import (FAMILIES, build_server, request_tape,
                                     run_saturation, synth_family)

from torch_cases import FIT_TOL, GBS_RTOL, _served

CPU = "cpu"


def _req(payload, t=0.0, family="f", tenant="ten", kind="predict"):
    return ServeRequest(kind=kind, tenant=tenant, family=family,
                        payload=payload, arrival=t)


def _recording_batcher(**kw):
    calls = []

    def dispatch(key, reqs):
        calls.append((key, list(reqs)))
        for r in reqs:
            r.future.set_result(r.payload)

    return MicroBatcher(dispatch, key_fn=lambda r: r.family, **kw), calls


# ------------------------------------------------------------ the batcher
class TestMicroBatcher:
    def test_deadline_flush_with_single_queued_request(self):
        now = [0.0]
        bat, calls = _recording_batcher(max_wait_s=0.002,
                                        clock=lambda: now[0])
        fut = bat.submit(_req("only", t=0.0))
        assert bat.pump(0.0015) == 0 and not fut.done  # deadline not due
        assert bat.pump(0.002) == 1                    # due: flush of one
        assert fut.done and fut.result(0) == "only"
        assert len(calls) == 1 and len(calls[0][1]) == 1
        assert bat.stats["deadline_flushes"] == 1

    def test_full_queue_flushes_inline(self):
        bat, calls = _recording_batcher(max_batch=4, max_wait_s=10.0)
        futs = [bat.submit(_req(i)) for i in range(4)]
        assert all(f.done for f in futs)  # saturation flush, no pump
        assert bat.stats["full_flushes"] == 1 and bat.depth == 0
        assert len(calls) == 1

    def test_buckets_group_by_key_and_keep_fifo(self):
        bat, calls = _recording_batcher(max_wait_s=10.0)
        for i, fam in enumerate("abab"):
            bat.submit(_req(i, family=fam))
        assert bat.flush() == 4
        assert len(calls) == 2  # one dispatch per bucket
        by_key = {key: [r.payload for r in reqs] for key, reqs in calls}
        assert by_key == {"a": [0, 2], "b": [1, 3]}

    def test_backpressure_rejects_at_max_queue(self):
        bat, _ = _recording_batcher(max_batch=2, max_queue=2,
                                    max_wait_s=10.0)
        bat._queue = [_req(0), _req(1)]  # saturate without flushing
        with pytest.raises(Backpressure):
            bat.submit(_req(2))
        assert bat.stats["rejected"] == 1

    def test_dispatch_error_scatters_to_futures(self):
        def boom(key, reqs):
            raise RuntimeError("bucket exploded")

        bat = MicroBatcher(boom, key_fn=lambda r: r.family, max_wait_s=10.0)
        f1, f2 = bat.submit(_req(1)), bat.submit(_req(2))
        assert bat.flush() == 2
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="bucket exploded"):
                f.result(0)

    def test_threaded_deadline_loop(self):
        bat, calls = _recording_batcher(max_wait_s=0.001)
        bat.start()
        try:
            fut = bat.submit(_req("bg", t=time.monotonic()))
            assert fut.result(timeout=2.0) == "bg"
        finally:
            bat.stop()
        assert bat._thread is None and len(calls) == 1

    def test_future_timeout(self):
        bat, _ = _recording_batcher(max_wait_s=10.0)
        fut = bat.submit(_req(0))
        with pytest.raises(TimeoutError):
            fut.result(timeout=0.01)


# ------------------------------------------------------------ tenant state
class TestTenantRegistry:
    def _seeded(self, n_tenants=2):
        reg = TenantRegistry(device=CPU)
        for i in range(n_tenants):
            reg.add_tenant(f"t{i}")
        mems, dts, inputs = synth_family(0)
        reg.seed("fam", "ks+", mems, dts, inputs)
        return reg

    def test_seed_shares_one_frozen_snapshot(self):
        reg = self._seeded()
        s0, s1 = reg.snapshot("t0", "fam"), reg.snapshot("t1", "fam")
        assert s0 is s1 and s0.version == 0
        assert s0.method_name == "ks+"
        assert s0.method.device == torch.device(CPU)  # fitted where asked

    def test_unknown_names_raise_loudly(self):
        reg = self._seeded()
        with pytest.raises(UnknownTenantError, match="ghost"):
            reg.snapshot("ghost", "fam")
        with pytest.raises(UnknownFamilyError, match="nope"):
            reg.snapshot("t0", "nope")
        with pytest.raises(ValueError, match="already exists"):
            reg.add_tenant("t0")

    def test_seed_requires_uniform_dt(self):
        reg = TenantRegistry(device=CPU)
        reg.add_tenant("t0")
        mems, dts, inputs = synth_family(0)
        dts = [1.0] * (len(dts) - 1) + [2.0]
        with pytest.raises(ValueError, match="uniform"):
            reg.seed("fam", "ks+", mems, dts, inputs)

    def test_refit_forks_only_the_refitting_tenant(self):
        reg = self._seeded()
        old = reg.snapshot("t0", "fam")
        events = []
        reg.on_refit(lambda *a: events.append(a))
        out = ExecutionOutcome(mem=np.full(40, 9.0), dt=1.0, input_gb=3.0,
                               succeeded=True)
        assert reg.observe("t0", "fam", out) == 1
        assert reg.refit("t0", "fam") is True
        new = reg.snapshot("t0", "fam")
        assert new is not old and new.version == 1 and new.sid != old.sid
        assert len(new.train_mems) == len(old.train_mems) + 1
        assert reg.snapshot("t1", "fam") is old  # other tenant untouched
        assert events == [("t0", "fam", old, new)]
        # pending was consumed: the policy is no longer due
        assert reg.refit("t0", "fam") is False

    def test_refit_policy_not_due(self):
        reg = self._seeded()
        out = ExecutionOutcome(mem=np.full(40, 9.0), dt=1.0, input_gb=3.0,
                               succeeded=True)
        reg.observe("t0", "fam", out)
        assert reg.refit("t0", "fam", policy="every_5") is False
        assert reg.snapshot("t0", "fam").version == 0

    def test_refit_offline_method_raises_named_error(self):
        reg = TenantRegistry(device=CPU)
        reg.add_tenant("t0")
        mems, dts, inputs = synth_family(0)
        reg.seed("frozen", "tovar-ppm", mems, dts, inputs)
        reg.observe("t0", "frozen", ExecutionOutcome(
            mem=np.full(40, 9.0), dt=1.0, input_gb=3.0, succeeded=True))
        with pytest.raises(MissingCapabilityError, match="online"):
            reg.refit("t0", "frozen")


# ----------------------------------------------------------------- caches
class TestCaches:
    def test_prediction_cache_hits_evictions_invalidation(self):
        cache = PredictionCache(max_entries=2)
        assert cache.get(1, 2.0) is None
        cache.put(1, 2.0, "a")
        cache.put(1, 3.0, "b")
        assert cache.get(1, 2.0) == "a"
        cache.put(2, 2.0, "c")  # evicts the oldest (sid 1, 2.0)
        assert cache.get(1, 2.0) is None
        assert cache.stats.evictions == 1
        assert cache.invalidate_sid(1) == 1  # the surviving sid-1 entry
        assert cache.get(1, 3.0) is None
        assert cache.get(2, 2.0) == "c"

    def test_program_cache_shapes_and_trace_residency(self):
        prog = ProgramCache()
        assert prog.note_shape("ks+", "fam", 4, 1.0, (8, 4)) is False
        assert prog.note_shape("ks+", "fam", 4, 1.0, (8, 4)) is True
        assert prog.distinct_shapes == 1
        builds = []
        got1 = prog.trace_batch("t0", "fam", 7,
                                lambda: builds.append(1) or "batch")
        got2 = prog.trace_batch("t0", "fam", 7,
                                lambda: builds.append(1) or "other")
        assert got1 == got2 == "batch" and builds == [1]
        assert prog.invalidate_tenant_family("t0", "fam") == 1
        prog.trace_batch("t0", "fam", 8, lambda: builds.append(1) or "b2")
        assert len(builds) == 2


# --------------------------------------------------------- serve dispatch
def _mixed_server(batching, *, tenants=6, seed=0, cls=PredictionServer,
                  **kw):
    srv = cls(batching=batching, cache_predictions=False, max_batch=64,
              max_wait_s=10.0, **kw)
    for i in range(tenants):
        srv.add_tenant(f"tenant{i}")
    for j, (family, method) in enumerate(FAMILIES):
        mems, dts, inputs = synth_family(seed + j)
        srv.seed_family(family, method, mems, dts, inputs)
    mems, dts, inputs = synth_family(seed + len(FAMILIES))
    srv.seed_family("kseg", "k-segments-selective", mems, dts, inputs)
    return srv


def _mixed_tape():
    tape = request_tape(96, 6, seed=11)
    return tape + [(t, "kseg", x) for t, _, x in request_tape(24, 6, seed=12)]


class TestServeDispatch:
    def test_batched_bitwise_equals_sequential_mixed_traffic(self):
        """The precision contract over every method family at once."""
        tape = _mixed_tape()
        batched = _mixed_server(batching=True, device=CPU)
        seq = _mixed_server(batching=False, device=CPU)
        got = _served(batched, tape)
        for (tenant, family, x), plan in zip(tape, got):
            single = seq.client(tenant).predict(family, x)
            assert np.array_equal(plan.starts, single.starts)
            assert np.array_equal(plan.peaks, single.peaks)
        # several tenants + families coalesced into few bucket dispatches
        assert batched.stats()["batcher"]["flushes"] < len(tape) / 10

    def test_served_plans_match_direct_method_oracle(self):
        """Server output == the fitted method's own predict(), bitwise."""
        srv = _mixed_server(batching=True, device=CPU)
        oracles = {}
        for j, (family, method) in enumerate(
                tuple(FAMILIES) + (("kseg", "k-segments-selective"),)):
            mems, dts, inputs = synth_family(j)
            m = registry.make(method, device=CPU)
            m.fit(mems, dts, inputs)
            oracles[family] = m
        client = srv.client("tenant0")
        for family, m in oracles.items():
            for x in (1.25, 3.0, 4.75):
                plan = client.predict(family, x)
                want = m.predict(x)
                assert np.array_equal(plan.starts, want.starts), family
                assert np.array_equal(plan.peaks, want.peaks), family

    def test_prediction_cache_and_refit_invalidation(self):
        srv = build_server(tenants=2, batching=True, seed=0, device=CPU)
        c = srv.client("tenant0")
        a = c.predict("align", 2.5)
        b = c.predict("align", 2.5)
        assert b is a  # submit-time hit: the cached plan object
        assert srv.predictions.stats.hits == 1
        # tenant1 shares the seed snapshot -> shares the cache entry
        assert srv.client("tenant1").predict("align", 2.5) is a
        c.observe("align", ExecutionOutcome(
            mem=np.full(40, 9.0), dt=1.0, input_gb=2.5, succeeded=True))
        assert c.refit("align") is True
        after = c.predict("align", 2.5)
        assert after is not a  # refit-scoped invalidation
        assert srv.client("tenant1").predict("align", 2.5) is a  # unscathed

    def test_evaluate_matches_fleet_oracle(self):
        srv = build_server(tenants=1, batching=True, seed=0, device=CPU)
        res = srv.client("tenant0").evaluate("align")
        mems, dts, inputs = synth_family(0)
        m = registry.make("ks+", device=CPU)
        m.fit(mems, dts, inputs)
        want = simulate_fleet_many(
            [(packed_predict(m, inputs), m.retry_spec)], list(mems),
            dts[0], machine_memory=128.0, device=CPU)[0]
        assert res.total_gbs == float(want.total_gbs)
        assert res.n == len(mems)
        assert res.succeeded == int(want.succeeded.sum())

    def test_tune_offset_matches_registry_oracle(self):
        srv = build_server(tenants=1, batching=True, seed=0, device=CPU)
        got = srv.client("tenant0").tune_offset("align")
        mems, dts, inputs = synth_family(0)
        m = registry.make("ks+", device=CPU)
        m.fit(mems, dts, inputs)
        best, totals = registry.tune_offset(m, mems, dts, inputs,
                                            machine_memory=128.0,
                                            device=CPU)
        assert got.best == best
        assert np.array_equal(got.totals, totals)

    def test_seed_rejects_unpacked_method(self):
        class NoPacked:
            def fit(self, mems, dts, inputs):
                pass

        @registry.register_method("test-nopack", retry=None, cls=NoPacked,
                                  packed=False)
        def _make(ctx):
            return NoPacked()

        try:
            srv = PredictionServer(device=CPU)
            srv.add_tenant("t0")
            mems, dts, inputs = synth_family(0)
            with pytest.raises(MissingCapabilityError, match="packed"):
                srv.seed_family("fam", "test-nopack", mems, dts, inputs)
        finally:
            registry.unregister_method("test-nopack")

    def test_unknown_kind_rejected(self):
        srv = build_server(tenants=1, batching=False, seed=0, device=CPU)
        with pytest.raises(ValueError, match="unknown request kind"):
            srv.submit("frobnicate", "tenant0", "align", 1.0)

    def test_threaded_server_round_trip(self):
        srv = build_server(tenants=2, batching=True, seed=0,
                           max_wait_s=0.001, device=CPU)
        srv.start()
        try:
            plans = [srv.client("tenant0").predict("align", 1.0 + 0.1 * i)
                     for i in range(5)]
        finally:
            srv.stop()
        assert all(p.peaks.size > 0 for p in plans)

    def test_concurrent_clients_threaded(self):
        """Many client threads against the background flush loop."""
        srv = build_server(tenants=4, batching=True, seed=0,
                           max_wait_s=0.001, device=CPU)
        srv.start()
        errors = []

        def worker(i):
            try:
                c = srv.client(f"tenant{i % 4}")
                for j in range(20):
                    p = c.predict("align", 1.0 + (i * 20 + j) % 40 * 0.1)
                    assert p.peaks.size > 0
            except BaseException as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        srv.stop()
        assert not any(t.is_alive() for t in threads)
        assert not errors

    def test_threaded_evaluate_and_tune_round_trip(self):
        """evaluate / tune_offset through the pump thread (the thread that
        runs the fleet engine), each wait bounded, equal to the manually
        drained server."""
        srv = build_server(tenants=2, batching=True, seed=0,
                           max_wait_s=0.001, device=CPU)
        ref = build_server(tenants=2, batching=True, seed=0, device=CPU)
        srv.start()
        try:
            futs = [srv.client(f"tenant{i % 2}").evaluate_async("align")
                    for i in range(4)]
            tune = srv.client("tenant1").tune_offset_async("assemble")
            got = [f.result(timeout=30.0) for f in futs]
            tuned = tune.result(timeout=30.0)
        finally:
            srv.stop()
        want = ref.client("tenant0").evaluate("align")
        for g in got:
            assert (g.total_gbs, g.succeeded, g.mean_attempts) == (
                want.total_gbs, want.succeeded, want.mean_attempts)
        want_t = ref.client("tenant1").tune_offset("assemble")
        assert tuned.best == want_t.best
        assert np.array_equal(tuned.totals, want_t.totals)


class TestShutdownAndLiveness:
    """``close()`` semantics and the refit-vs-predict liveness contract:
    shutdown never strands a blocked caller, and concurrent refits never
    leave the prediction/program caches pointing at dead snapshots."""

    def test_close_fails_queued_futures(self):
        bat = MicroBatcher(lambda key, reqs: None, lambda r: r.family,
                           max_wait_s=10.0)
        futs = [bat.submit(_req(float(i), t=0.0)) for i in range(3)]
        bat.close()
        for f in futs:
            assert f.done
            with pytest.raises(ServerClosed, match="still queued"):
                f.result(0)

    def test_submit_after_close_rejected(self):
        bat = MicroBatcher(lambda key, reqs: None, lambda r: r.family)
        bat.close()
        with pytest.raises(ServerClosed, match="rejected"):
            bat.submit(_req(1.0))

    def test_close_stops_pump_thread_and_is_idempotent(self):
        bat = MicroBatcher(lambda key, reqs: None, lambda r: r.family,
                           max_wait_s=10.0)
        bat.start()
        fut = bat.submit(_req(1.0, t=time.monotonic()))
        bat.close()
        assert bat._thread is None
        with pytest.raises(ServerClosed):
            fut.result(0)
        bat.close()  # second close is a no-op, not an error

    def test_stop_drains_close_abandons(self):
        served = []
        bat = MicroBatcher(
            lambda key, reqs: [r.future.set_result(served.append(r.payload))
                               for r in reqs],
            lambda r: r.family, max_wait_s=10.0)
        bat.start()
        bat.submit(_req(1.0, t=time.monotonic()))
        bat.stop()  # stop flushes what is pending
        assert served == [1.0]
        bat.submit(_req(2.0, t=time.monotonic()))
        bat.close()  # close drops it
        assert served == [1.0]

    def test_blocked_caller_unblocked_by_close(self):
        """A caller waiting in result() gets ServerClosed, not a hang."""
        bat = MicroBatcher(lambda key, reqs: None, lambda r: r.family,
                           max_wait_s=60.0)
        fut = bat.submit(_req(1.0, t=time.monotonic()))
        caught = []

        def waiter():
            try:
                fut.result(30.0)
            except BaseException as exc:
                caught.append(exc)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)  # let the waiter block on the future
        bat.close()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert len(caught) == 1 and isinstance(caught[0], ServerClosed)

    def test_server_context_manager_closes(self):
        with build_server(tenants=1, seed=0, device=CPU) as srv:
            assert srv.client("tenant0").predict("align", 1.5).peaks.size
        with pytest.raises(ServerClosed):
            srv.submit("predict", "tenant0", "align", 9.9)

    def test_threaded_refit_vs_predict_liveness(self):
        """Tenant refits race reader predictions on the live thread; the
        copy-on-refit snapshots keep readers on their seed sid, and at
        quiescence every cached prediction belongs to a live snapshot."""
        srv = build_server(tenants=4, batching=True, seed=0,
                           max_wait_s=0.001, device=CPU)
        srv.start()
        errors: list = []
        stop_evt = threading.Event()
        seed_sid = srv.tenants.snapshot("tenant1", "align").sid

        def reader(i):
            try:
                c = srv.client(f"tenant{i}")
                while not stop_evt.is_set():
                    p = c.predict("align", 1.0 + 0.1 * (i % 8))
                    assert p.peaks.size > 0
            except BaseException as exc:  # pragma: no cover - failure path
                errors.append(exc)

        def writer():
            try:
                c = srv.client("tenant0")
                for j in range(8):
                    c.observe("align", ExecutionOutcome(
                        mem=np.full(40, 5.0 + j), dt=1.0, input_gb=2.0,
                        succeeded=True))
                    assert c.refit("align") is True
                    assert c.predict("align", 2.0).peaks.size > 0
            except BaseException as exc:  # pragma: no cover - failure path
                errors.append(exc)

        readers = [threading.Thread(target=reader, args=(i,))
                   for i in (1, 2, 3)]
        wt = threading.Thread(target=writer)
        for t in readers:
            t.start()
        wt.start()
        wt.join(timeout=30.0)
        stop_evt.set()
        for t in readers:
            t.join(timeout=30.0)
        srv.stop()
        assert not errors
        assert not wt.is_alive() and not any(t.is_alive() for t in readers)
        # Readers stayed on the seed snapshot; the writer moved off it.
        for i in (1, 2, 3):
            assert srv.tenants.snapshot(f"tenant{i}", "align").sid == seed_sid
        assert srv.tenants.snapshot("tenant0", "align").sid != seed_sid
        # Quiescent cache invariant: every cached sid is still served by
        # some tenant — refit invalidation left no dead-snapshot entries.
        with srv.predictions._lock:
            cached_sids = [sid for sid, keys in
                           srv.predictions._by_sid.items() if keys]
        assert cached_sids
        for sid in cached_sids:
            assert srv._sid_live(sid), f"dead snapshot {sid} still cached"


# ------------------------------------------------ against the reference
def _fields(cand):
    """An OffsetCandidate of either package as a plain tuple."""
    return (cand.peak, cand.start, cand.last_peak_bump)


class TestMatchesReference:
    def test_served_plans_match_reference(self):
        """Mixed traffic over every method family, batched, through both
        packages' servers: the same plans within the fit tolerance."""
        tape = _mixed_tape()
        got = _served(_mixed_server(batching=True, device=CPU), tape)
        want = _served(_mixed_server(batching=True, cls=RServer), tape)
        for (tenant, family, x), a, b in zip(tape, got, want):
            np.testing.assert_allclose(a.starts, b.starts, **FIT_TOL,
                                       err_msg=f"{family} {x}")
            np.testing.assert_allclose(a.peaks, b.peaks, **FIT_TOL,
                                       err_msg=f"{family} {x}")

    @pytest.mark.parametrize("family", [f for f, _ in FAMILIES])
    def test_evaluate_and_tune_match_reference(self, family):
        srv = build_server(tenants=1, seed=0, device=CPU)
        ref = r_bench.build_server(tenants=1, seed=0)
        got = srv.client("tenant0").evaluate(family)
        want = ref.client("tenant0").evaluate(family)
        assert (got.n, got.succeeded, got.mean_attempts) == (
            want.n, want.succeeded, want.mean_attempts)
        np.testing.assert_allclose(got.total_gbs, want.total_gbs,
                                   rtol=GBS_RTOL)
        got = srv.client("tenant0").tune_offset(family)
        want = ref.client("tenant0").tune_offset(family)
        assert _fields(got.best) == _fields(want.best)
        np.testing.assert_allclose(got.totals, want.totals, rtol=GBS_RTOL)

    def test_saturation_contract_holds(self):
        """``python -m repro_torch.serve``'s gates at a small size:
        batched plans bitwise equal to unbatched, no warm build or load,
        cache hits on repeat traffic."""
        out = run_saturation(tenants=2, n_requests=256, rate_rps=2000.0,
                             seed=0, device=CPU)
        assert out["throughput"]["bitwise"] is True
        assert out["discipline"]["warm_zero_compiles"] is True
        assert out["discipline"]["cache_hit_ok"] is True
        assert out["latency"]["served"] == 256

    def test_serve_demo_admits_the_same_batches(self):
        from repro.launch.serve import serve_demo as r_serve_demo
        from repro_torch.launch.serve import serve_demo
        got = serve_demo("qwen3-1.7b", device=CPU)
        want = r_serve_demo("qwen3-1.7b")
        assert (got["served"], got["batches"]) == (want["served"],
                                                   want["batches"])

    @pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-vl-72b",
                                      "hubert-xlarge"])
    def test_serve_demo_moe_vlm_audio(self, arch):
        """olmoe and qwen2-vl (embeds with 3-axis positions) are admitted
        in the reference's batches; hubert, encoder-only, exits on both
        sides.  Six requests of 4 new tokens keep the reference's eager
        loop short."""
        from repro.launch.serve import serve_demo as r_serve_demo
        from repro_torch.launch.serve import serve_demo
        kw = dict(requests=6, new_tokens=4)
        if arch == "hubert-xlarge":
            with pytest.raises(SystemExit, match="encoder-only"):
                serve_demo(arch, device=CPU, **kw)
            with pytest.raises(SystemExit, match="encoder-only"):
                r_serve_demo(arch, **kw)
            return
        got = serve_demo(arch, device=CPU, **kw)
        want = r_serve_demo(arch, **kw)
        assert (got["served"], got["batches"]) == (want["served"],
                                                   want["batches"])

    def test_kv_envelope_identical(self):
        from repro.configs import smoke_config as r_smoke
        from repro.launch.serve import kv_envelope as r_kv
        from repro_torch.configs import smoke_config
        from repro_torch.launch.serve import kv_envelope
        for arch in ("qwen3-1.7b", "zamba2-2.7b", "mamba2-780m"):
            np.testing.assert_array_equal(
                kv_envelope(smoke_config(arch), 2, 64, 16),
                r_kv(r_smoke(arch), 2, 64, 16))

