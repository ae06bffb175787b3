"""Parity of the port's host envelope layer with the reference package.

``repro_torch.core.envelope`` / ``allocation`` / ``retry`` / ``wastage`` are
numpy carried over from ``repro.core``: the same seeded inputs must give
bitwise-equal outputs in both packages (tolerance: none).
"""

import numpy as np
import pytest

import repro.core.allocation as a_ref
import repro.core.envelope as e_ref
import repro.core.retry as r_ref
import repro.core.wastage as w_ref
import repro_torch.core.allocation as a_pt
import repro_torch.core.envelope as e_pt
import repro_torch.core.retry as r_pt
import repro_torch.core.wastage as w_pt

KINDS = ["ksplus", "kseg-selective", "kseg-partial", "double",
         "max-machine", "none"]


def _plans(mod, rng, B, kmax=6):
    plans = []
    for _ in range(B):
        n = int(rng.integers(1, kmax + 1))
        starts = np.sort(rng.uniform(0, 80, n))
        starts[0] = 0.0
        peaks = np.maximum.accumulate(rng.uniform(1, 16, n))
        plans.append(mod.AllocationPlan(starts=starts, peaks=peaks))
    return plans


def _packed(seed, B=17, k=None):
    """The same seeded plans packed by both packages."""
    ref = e_ref.PackedEnvelopes.from_plans(
        _plans(a_ref, np.random.default_rng(seed), B), k)
    pt = e_pt.PackedEnvelopes.from_plans(
        _plans(a_pt, np.random.default_rng(seed), B), k)
    return ref, pt


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


class TestPacking:
    @pytest.mark.parametrize("k", [None, 10])
    def test_from_plans_bitwise(self, k):
        ref, pt = _packed(0, k=k)
        _same((ref.starts, ref.peaks, ref.nseg), (pt.starts, pt.peaks, pt.nseg))
        for i in range(ref.B):
            _same(ref.row(i), pt.row(i))

    def test_pad_start_and_too_many_segments(self):
        assert e_pt.PAD_START == e_ref.PAD_START
        p = a_pt.AllocationPlan(np.asarray([0.0, 1.0]), np.asarray([1.0, 2.0]))
        with pytest.raises(ValueError):
            e_pt.PackedEnvelopes.from_plans([p], k=1)


class TestAllocAndViolation:
    @pytest.mark.parametrize("per_lane", [False, True])
    def test_alloc_at_packed(self, per_lane):
        ref, pt = _packed(1)
        rng = np.random.default_rng(2)
        t = rng.uniform(0, 120, (ref.B, 33) if per_lane else 64)
        _same(e_ref.alloc_at_packed(ref.starts, ref.peaks, t),
              e_pt.alloc_at_packed(pt.starts, pt.peaks, t))

    @pytest.mark.parametrize("dt", [0.7, 1.0])
    def test_first_violation_packed(self, dt):
        ref, pt = _packed(3, B=24)
        rng = np.random.default_rng(3)
        mems = np.abs(rng.normal(6, 4, (24, 96)))
        lengths = rng.integers(8, 97, 24)
        _same(e_ref.first_violation_packed(ref.starts, ref.peaks, mems,
                                           lengths, dt),
              e_pt.first_violation_packed(pt.starts, pt.peaks, mems,
                                          lengths, dt))

    def test_scalar_views(self):
        rng = np.random.default_rng(4)
        for pr, pp in zip(_plans(a_ref, np.random.default_rng(4), 8),
                          _plans(a_pt, np.random.default_rng(4), 8)):
            t = rng.uniform(0, 100, 20)
            mem = np.abs(rng.normal(6, 4, 50))
            _same(a_ref.alloc_at(pr, t), a_pt.alloc_at(pp, t))
            _same(a_ref.alloc_series(pr, 50, 0.5),
                  a_pt.alloc_series(pp, 50, 0.5))
            assert a_ref.first_violation(pr, mem, 0.5) == \
                a_pt.first_violation(pp, mem, 0.5)
            assert pr.segment_at(40.0) == pp.segment_at(40.0)
            assert pr.is_monotone() == pp.is_monotone()


class TestSpanArithmetic:
    @pytest.mark.parametrize("dt", [1.0, 0.3, 2.5])
    def test_bounds_and_span_sum(self, dt):
        ref, pt = _packed(5, B=20)
        upto = np.random.default_rng(5).integers(1, 128, 20)
        b_ref = e_ref.segment_sample_bounds(ref.starts, dt)
        b_pt = e_pt.segment_sample_bounds(pt.starts, dt)
        _same(b_ref, b_pt)
        _same(e_ref.span_alloc_sum(ref.peaks, b_ref, upto),
              e_pt.span_alloc_sum(pt.peaks, b_pt, upto))


class TestResidual:
    @pytest.mark.parametrize("windowed", [False, True])
    def test_usage_residual_fits(self, windowed):
        ref, pt = _packed(6, B=5)
        rng = np.random.default_rng(6)
        t0 = rng.uniform(0, 30, 5)
        dur = rng.uniform(10, 60, 5) if windowed else None
        grid = rng.uniform(0, 120, (3, 16))
        need = rng.uniform(10, 40, (3, 16))
        _same(e_ref.usage_over(ref.starts, ref.peaks, t0, grid, dur),
              e_pt.usage_over(pt.starts, pt.peaks, t0, grid, dur))
        _same(e_ref.fits_column(64.0, ref.starts, ref.peaks, t0, need,
                                grid, dur),
              e_pt.fits_column(64.0, pt.starts, pt.peaks, t0, need, grid,
                               dur))

    def test_apply_offsets(self):
        ref, pt = _packed(7)
        rng = np.random.default_rng(7)
        cands = [dict(), dict(peak=0.1, start=0.05),
                 dict(peak=rng.uniform(-0.1, 0.2, ref.B),
                      start=rng.uniform(0, 0.2, ref.B))]
        for c in cands:
            _same(e_ref.apply_offsets(ref.starts, ref.peaks, ref.nseg,
                                      e_ref.OffsetCandidate(**c)),
                  e_pt.apply_offsets(pt.starts, pt.peaks, pt.nseg,
                                     e_pt.OffsetCandidate(**c)))


class TestRetry:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("per_lane_bump", [False, True])
    def test_retry_packed(self, kind, per_lane_bump):
        ref, pt = _packed(8, B=30)
        rng = np.random.default_rng(8)
        t_fail = rng.uniform(0, 100, 30)
        used = rng.uniform(1, 30, 30)
        bump = rng.uniform(0.05, 0.5, 30) if per_lane_bump else None
        _same(e_ref.retry_packed(e_ref.RetrySpec(kind), ref.starts,
                                 ref.peaks, ref.nseg, t_fail, used,
                                 machine_memory=64.0, bump=bump),
              e_pt.retry_packed(e_pt.RetrySpec(kind), pt.starts, pt.peaks,
                                pt.nseg, t_fail, used, machine_memory=64.0,
                                bump=bump))

    def test_per_plan_rules(self):
        rng = np.random.default_rng(9)
        for pr, pp in zip(_plans(a_ref, np.random.default_rng(9), 10),
                          _plans(a_pt, np.random.default_rng(9), 10)):
            t, u = float(rng.uniform(0, 90)), float(rng.uniform(1, 20))
            for name, kw in (("ksplus_retry", {}),
                             ("ksegments_selective_retry", {}),
                             ("ksegments_partial_retry", {}),
                             ("double_retry", {"cap": 32.0}),
                             ("max_machine_retry", {"machine_memory": 32.0})):
                a = getattr(r_ref, name)(pr, t, u, **kw)
                b = getattr(r_pt, name)(pp, t, u, **kw)
                _same((a.starts, a.peaks), (b.starts, b.peaks))

    def test_unknown_kind_raises(self):
        env = e_pt.PackedEnvelopes.from_plans(
            [a_pt.AllocationPlan(np.zeros(1), np.ones(1))])
        with pytest.raises(ValueError):
            e_pt.retry_packed(e_pt.RetrySpec("bogus"), env.starts, env.peaks,
                              env.nseg, [0.0], [1.0])


class TestWastageOracles:
    @pytest.mark.parametrize("kind", ["ksplus", "double", "kseg-partial"])
    def test_simulate_execution(self, kind):
        rng = np.random.default_rng(10)
        for pr, pp in zip(_plans(a_ref, np.random.default_rng(10), 8),
                          _plans(a_pt, np.random.default_rng(10), 8)):
            mem = np.abs(rng.normal(8, 5, int(rng.integers(5, 120))))
            spec_r, spec_p = e_ref.RetrySpec(kind), e_pt.RetrySpec(kind)
            a = w_ref.simulate_execution(
                pr, lambda p, t, u: r_ref.apply_retry_spec(
                    spec_r, p, t, u, 24.0), mem, 1.0, machine_memory=24.0)
            b = w_pt.simulate_execution(
                pp, lambda p, t, u: r_pt.apply_retry_spec(
                    spec_p, p, t, u, 24.0), mem, 1.0, machine_memory=24.0)
            assert (a.wastage_gbs, a.succeeded, a.num_retries) == \
                (b.wastage_gbs, b.succeeded, b.num_retries)
            for x, y in zip(a.attempts, b.attempts):
                assert (x.failed_at, x.wastage_gbs) == \
                    (y.failed_at, y.wastage_gbs)

    @pytest.mark.parametrize("dt", [0.5, 1.0])
    def test_batched_oracles(self, dt):
        rng = np.random.default_rng(11)
        B, T, k = 8, 200, 4
        starts = np.sort(rng.uniform(0, 150, (B, k)), axis=1)
        starts[:, 0] = 0
        peaks = np.sort(rng.uniform(1, 6, (B, k)), axis=1)
        mems = np.abs(rng.normal(3, 1.5, (B, T)))
        lengths = rng.integers(1, T, B)
        _same(w_ref.oom_probe_ref(starts, peaks, mems, lengths, dt),
              w_pt.oom_probe_ref(starts, peaks, mems, lengths, dt))
        _same(w_ref.wastage_eval_ref(starts, peaks, mems, lengths, dt),
              w_pt.wastage_eval_ref(starts, peaks, mems, lengths, dt))
