"""The port's fleet engine against the reference engine and the oracle.

* Identical packed plans and traces through ``repro_torch.core.fleet`` (on
  the CPU: the PyTorch path) and ``repro.core.fleet`` (``backend="jnp"``):
  attempts and success flags exact, wastage within rtol 1e-5 (both run in
  float32; only summation order differs).
* Against :func:`repro_torch.core.wastage.simulate_execution`, as the
  reference's own ``tests/test_fleet.py`` does: retries and success exact,
  wastage within its rtol 5e-4 / atol 5e-2 (float32 engine vs float64
  oracle).
"""

import numpy as np
import pytest
import torch

import repro.core.fleet as f_ref
import repro_torch.core.fleet as f_pt
from repro_torch.core import (
    AllocationPlan,
    DefaultMethod,
    KSegments,
    KSPlus,
    KSPlusAuto,
    PPMImproved,
    RetrySpec,
    TovarPPM,
    WittPercentile,
    ksplus_retry,
    simulate_execution,
)
from repro_torch.kernels.wastage import ops
from repro_torch.traces import eager

CPU = "cpu"
WTOL = dict(rtol=5e-4, atol=5e-2)
KINDS = ["ksplus", "kseg-selective", "kseg-partial", "double",
         "max-machine", "none"]


def _traces(seed, n=40):
    rng = np.random.default_rng(seed)
    mems = []
    for _ in range(n):
        L = int(rng.integers(1, 300))
        base = rng.uniform(0.5, 4.0)
        step = int(rng.integers(0, L))
        m = np.full(L, base)
        m[step:] += rng.uniform(0.0, 6.0)
        mems.append(np.abs(m + rng.normal(0, 0.05, L)))
    return mems


def _plans(seed, mems, K=4, nonmono=False):
    rng = np.random.default_rng(seed + 1)
    B = len(mems)
    starts = np.sort(rng.uniform(0, 1, (B, K)), axis=1) \
        * np.asarray([len(m) for m in mems])[:, None]
    starts[:, 0] = 0.0
    peaks = rng.uniform(0.3, 1.2, (B, K)) * \
        np.asarray([m.max() for m in mems])[:, None]
    if not nonmono:
        peaks = np.sort(peaks, axis=1)
    nseg = rng.integers(1, K + 1, B).astype(np.int32)
    real = np.arange(K)[None, :] < nseg[:, None]
    last = np.take_along_axis(peaks, (nseg - 1)[:, None], axis=1)
    starts = np.where(real, starts, f_pt.PAD_START)
    peaks = np.where(real, peaks, last)
    return starts.astype(np.float32), peaks.astype(np.float32), nseg


def _both(jobs, mems, **kw):
    """Run the same jobs through both engines (port on the CPU)."""
    ref = f_ref.simulate_fleet_many(jobs, f_ref.bucket_traces(mems),
                                    backend="jnp", **kw)
    pt = f_pt.simulate_fleet_many(jobs, f_pt.bucket_traces(mems, device=CPU),
                                  **kw)
    return ref, pt


def _assert_same(ref, pt):
    for a, b in zip(ref, pt):
        np.testing.assert_array_equal(a.attempts, b.attempts)
        np.testing.assert_array_equal(a.succeeded, b.succeeded)
        np.testing.assert_allclose(b.wastage_gbs, a.wastage_gbs, rtol=1e-5)


class TestAgainstReferenceEngine:
    @pytest.mark.parametrize("kind", KINDS)
    def test_every_retry_kind(self, kind):
        mems = _traces(1)
        plans = _plans(1, mems, nonmono=kind.startswith("kseg"))
        spec = RetrySpec(kind)
        _assert_same(*_both([(plans, spec)], mems, dt=1.0,
                            machine_memory=12.0))

    def test_many_jobs_and_buckets(self):
        mems = _traces(2, n=60)
        jobs = [(_plans(s, mems, K=K), RetrySpec(kind))
                for s, (K, kind) in enumerate([(4, "ksplus"), (1, "double"),
                                               (8, "ksplus"),
                                               (4, "kseg-partial")])]
        _assert_same(*_both(jobs, mems, dt=0.5, machine_memory=9.0))

    def test_per_lane_bump(self):
        mems = _traces(3)
        plans = _plans(3, mems)
        bump = np.random.default_rng(3).uniform(0.05, 0.6, len(mems))
        bump[::5] = np.nan  # NaN keeps the spec's static bump
        _assert_same(*_both([(plans, RetrySpec("ksplus", bump=0.2), bump)],
                            mems, dt=1.0, machine_memory=16.0))

    def test_machine_memory_exhaustion(self):
        mems = _traces(4)
        mems[0] = np.full(20, 50.0)   # above the machine: unsatisfiable
        mems[1] = np.full(7, 30.0)
        plans = _plans(4, mems)
        ref, pt = _both([(plans, RetrySpec("double"))], mems, dt=1.0,
                        machine_memory=16.0, max_attempts=6)
        _assert_same(ref, pt)
        assert not pt[0].succeeded[0] and not pt[0].succeeded[1]

    def test_max_attempts_exhaustion(self):
        mems = [np.full(8, 10.0)] * 3
        plans = (np.zeros((3, 1), np.float32), np.full((3, 1), 2.0, np.float32),
                 np.ones(3, np.int32))
        ref, pt = _both([(plans, RetrySpec("none"))], mems, dt=1.0,
                        machine_memory=16.0, max_attempts=5)
        _assert_same(ref, pt)
        assert (pt[0].attempts == 5).all() and not pt[0].succeeded.any()


class TestSegBounds:
    @pytest.mark.parametrize("dt", [0.1, 0.3, 1.0, 2.5])
    def test_ulp_edge_starts(self, dt):
        """Starts on the float32 grid and one ulp either side of it."""
        i = np.arange(1, 200, dtype=np.float32)
        grid = i * np.float32(dt)
        s = np.concatenate([grid, np.nextafter(grid, np.float32(0)),
                            np.nextafter(grid, np.float32(np.inf))])
        s = np.concatenate([s, np.float32([0.0, 1e30])]).astype(np.float32)
        # slot 0 is always active from t = 0; the edge starts go in slot 1
        starts = np.stack([np.zeros_like(s), s], axis=1)
        got = f_pt._seg_bounds(torch.from_numpy(starts.copy()), dt).numpy()
        want = np.asarray(f_ref._seg_bounds(starts, dt))
        np.testing.assert_array_equal(got, want)
        # and against the per-sample truth: first i with f32(i)*dt >= s
        t = np.arange(4096, dtype=np.float32) * np.float32(dt)
        for row, b in zip(starts[:-1, 1], got[:-1, 1]):
            assert b == int(np.argmax(t >= row))

    def test_probe_then_retry_on_packed_traces(self):
        """Attempt 1 settles the fitting lane; the killed lane retries."""
        plans = [AllocationPlan(np.asarray([0.0, 10.0]), np.asarray([2.0, 4.0])),
                 AllocationPlan(np.zeros(1), np.asarray([4.0]))]
        mems = [np.concatenate([np.full(10, 1.5), np.full(22, 4.5)]),
                np.full(16, 3.0)]
        fr = f_pt.simulate_fleet(plans, RetrySpec("ksplus"),
                                 f_pt.pack_traces(mems, min_t=32), 1.0,
                                 machine_memory=16.0, device=CPU)
        assert list(fr.attempts) == [2, 1] and fr.succeeded.all()
        # the fitting lane's wastage is its span arithmetic: (4 - 3) * 16
        assert fr.wastage_gbs[1] == pytest.approx(16.0, rel=1e-6)
        for i in range(2):
            res = simulate_execution(plans[i], ksplus_retry, mems[i], 1.0,
                                     machine_memory=16.0)
            assert fr.retries[i] == res.num_retries
            assert bool(fr.succeeded[i]) == res.succeeded
            assert fr.wastage_gbs[i] == pytest.approx(res.wastage_gbs,
                                                      rel=5e-4)


def _zoo(machine, limit=8.0, k=4):
    return {
        "ks+": KSPlus(k=k, device=CPU),
        "ks+auto": KSPlusAuto(machine_memory=machine, candidates=(2, 3, 4),
                              device=CPU),
        "k-segments-selective": KSegments(k=k, variant="selective",
                                          device=CPU),
        "k-segments-partial": KSegments(k=k, variant="partial", device=CPU),
        "tovar-ppm": TovarPPM(machine_memory=machine),
        "ppm-improved": PPMImproved(machine_memory=machine),
        "witt-p95": WittPercentile(percentile=95.0, machine_memory=machine),
        "default": DefaultMethod(limit_gb=limit, machine_memory=machine),
    }


class TestAgainstOracle:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_all_methods_match_oracle(self, seed):
        wf = eager(8)
        train, test = wf.split(seed, 0.5, 1.0)
        for fname in list(train)[:3]:
            te = test[fname]
            mems = [e.mem for e in train[fname]]
            dts = [e.dt for e in train[fname]]
            inputs = [e.input_gb for e in train[fname]]
            for mname, method in _zoo(128.0).items():
                method.fit(mems, dts, inputs)
                plans = [method.predict(e.input_gb) for e in te]
                fr = f_pt.simulate_fleet(
                    plans, method.retry_spec, [e.mem for e in te], 1.0,
                    machine_memory=128.0, device=CPU)
                for i, e in enumerate(te):
                    res = simulate_execution(plans[i], method.retry, e.mem,
                                             e.dt, machine_memory=128.0)
                    ctx = f"seed={seed} {fname} {mname} lane={i}"
                    assert res.num_retries == fr.retries[i], ctx
                    assert res.succeeded == bool(fr.succeeded[i]), ctx
                    np.testing.assert_allclose(
                        fr.wastage_gbs[i], res.wastage_gbs, err_msg=ctx,
                        **WTOL)

    @pytest.mark.parametrize("case", ["last-segment", "retime", "single"])
    def test_edge_cases(self, case):
        if case == "last-segment":
            plans = [AllocationPlan(np.asarray([0.0, 10.0]),
                                    np.asarray([2.0, 4.0]))]
            mems = [np.concatenate([np.full(10, 1.5), np.full(20, 4.5)])]
        elif case == "retime":
            plans = [AllocationPlan(np.asarray([0.0, 30.0]),
                                    np.asarray([2.0, 6.0]))]
            mems = [np.concatenate([np.full(20, 1.5), np.full(20, 5.0)])]
        else:
            plans = [AllocationPlan(np.zeros(1), np.asarray([4.0])),
                     AllocationPlan(np.zeros(1), np.asarray([2.0]))]
            mems = [np.asarray([3.0]), np.asarray([3.0])]
        fr = f_pt.simulate_fleet(plans, RetrySpec("ksplus"), mems, 1.0,
                                 machine_memory=16.0, device=CPU)
        for i, (p, m) in enumerate(zip(plans, mems)):
            res = simulate_execution(p, ksplus_retry, m, 1.0,
                                     machine_memory=16.0)
            assert res.num_retries == fr.retries[i]
            assert res.succeeded == bool(fr.succeeded[i])
            np.testing.assert_allclose(fr.wastage_gbs[i], res.wastage_gbs,
                                       **WTOL)


class TestBatchHandling:
    def test_subset_batch_is_bitwise(self):
        mems = _traces(5, n=50)
        plans = _plans(5, mems)
        batch = f_pt.bucket_traces(mems, device=CPU)
        full = f_pt.simulate_fleet(plans, "ksplus", batch, 1.0,
                                   machine_memory=12.0)
        lanes = np.arange(0, 50, 3)
        sub = f_pt.simulate_fleet(plans, "ksplus",
                                  f_pt.subset_batch(batch, lanes), 1.0,
                                  machine_memory=12.0)
        np.testing.assert_array_equal(sub.wastage_gbs[lanes],
                                      full.wastage_gbs[lanes])
        np.testing.assert_array_equal(sub.attempts[lanes],
                                      full.attempts[lanes])

    def test_backend_and_device_checks(self):
        """The route follows the batch's device: a CPU batch runs the
        PyTorch formulation and launches no kernel; a batch is never moved
        to another device; plan and trace counts must agree."""
        mems = _traces(6, n=4)
        plans = _plans(6, mems)
        batch = f_pt.bucket_traces(mems, device=CPU)
        ops.reset_launches()
        f_pt.simulate_fleet(plans, "ksplus", batch, machine_memory=12.0)
        assert ops.LAUNCHES == {"oom_probe": 0, "wastage_eval": 0}
        with pytest.raises(ValueError):
            f_pt.simulate_fleet(plans, "ksplus", batch, device="meta")
        with pytest.raises(ValueError):
            f_pt.simulate_fleet(plans[:2], "ksplus", batch)
