"""Predictors: fit parity with the reference, and state carried across.

* Fit parity: every registered method fitted on the same seeded training
  split in both packages (the port on the CPU) gives the same chosen k, the
  same retry rule and plans within rtol 1e-5 / atol 1e-5 GB·s — float32
  regressions whose sums run in another order.
* ``registry.load_fitted``: a reference fit's numpy state rebuilt as a port
  method predicts bitwise-identical packed plans, and replays and tunes
  offsets like the reference engine (attempts exact, GB·s rtol 1e-5).
"""

import numpy as np
import pytest

import repro.core.baselines as b_ref
import repro.core.ksplus as k_ref
from repro.core import registry as reg_ref
from repro.core.fleet import packed_predict as pp_ref
from repro.core.fleet import simulate_fleet as sim_ref
from repro_torch.core import ExecutionOutcome
from repro_torch.core import registry as reg_pt
from repro_torch.core.fleet import packed_predict as pp_pt
from repro_torch.core.fleet import simulate_fleet as sim_pt
from repro_torch.traces import eager

CPU = "cpu"
FAMILIES = ["bwa", "dedup", "qualimap"]


@pytest.fixture(scope="module")
def data():
    train, test = eager(12).split(0, 0.5, 1.0)
    out = {}
    for f in FAMILIES:
        tr = train[f]
        out[f] = ([e.mem for e in tr], [e.dt for e in tr],
                  [e.input_gb for e in tr], [e.input_gb for e in test[f]],
                  [e.mem for e in test[f]])
    return out


def state_of(m):
    """A fitted reference method's state as plain numpy."""
    if isinstance(m, k_ref.KSPlusAuto):
        return {"chosen_k": m.chosen_k, "model": state_of(m._model)}
    if isinstance(m, k_ref.KSPlus):
        sm = m._model
        return {"model": {
            "k": sm.k,
            "start_slope": sm.start_reg.slope,
            "start_intercept": sm.start_reg.intercept,
            "peak_slope": sm.peak_reg.slope,
            "peak_intercept": sm.peak_reg.intercept,
            "runtime_slope": sm.runtime_reg.slope,
            "runtime_intercept": sm.runtime_reg.intercept},
            "rows": m._rows}
    if isinstance(m, b_ref.KSegments):
        return {"runtime_slope": m._runtime_reg.slope,
                "runtime_intercept": m._runtime_reg.intercept,
                "peak_slope": m._peak_reg.slope,
                "peak_intercept": m._peak_reg.intercept, "rows": m._rows}
    if isinstance(m, b_ref.TovarFeedback):
        return {"first_alloc": m._first_alloc, "peaks": m._peaks,
                "runtimes": m._runtimes}
    if isinstance(m, b_ref.PPMImproved):
        return {"first_alloc": m._inner._first_alloc}
    if isinstance(m, (b_ref.TovarPPM, b_ref.WittPercentile)):
        return {"first_alloc": m._first_alloc}
    return {}


def _fit_both(name, fam_data):
    mems, dts, inputs = fam_data[:3]
    ref = reg_ref.make(name, k=4, machine_memory=128.0, default_limit=6.0)
    pt = reg_pt.make(name, k=4, machine_memory=128.0, default_limit=6.0,
                     device=CPU)
    ref.fit(mems, dts, inputs)
    pt.fit(mems, dts, inputs)
    return ref, pt


@pytest.mark.parametrize("name", reg_pt.method_names())
def test_fit_parity(name, data):
    assert reg_pt.method_names() == reg_ref.method_names()
    for fam in FAMILIES:
        ref, pt = _fit_both(name, data[fam])
        assert pt.name == ref.name
        assert tuple(pt.retry_spec) == tuple(ref.retry_spec)
        if name == "ks+auto":
            assert pt.chosen_k == ref.chosen_k, fam
        test_inputs = data[fam][3]
        a, b = pp_ref(ref, test_inputs), pp_pt(pt, test_inputs)
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b[1], a[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", reg_pt.method_names())
def test_load_fitted_round_trip(name, data):
    for fam in FAMILIES:
        mems, dts, inputs, test_inputs, test_mems = data[fam]
        ref = reg_ref.make(name, k=4, machine_memory=128.0, default_limit=6.0)
        ref.fit(mems, dts, inputs)
        ctor = {"limit_gb": 6.0} if name == "default" else {}
        pt = reg_pt.load_fitted(name, state_of(ref), device=CPU, **ctor)
        assert pt.name == ref.name
        for a, b in zip(pp_ref(ref, test_inputs), pp_pt(pt, test_inputs)):
            np.testing.assert_array_equal(a, b)
        fr = sim_ref(pp_ref(ref, test_inputs), ref.retry_spec, test_mems,
                     1.0, machine_memory=128.0, backend="jnp")
        fp = sim_pt(pp_pt(pt, test_inputs), pt.retry_spec, test_mems, 1.0,
                    machine_memory=128.0, device=CPU)
        np.testing.assert_array_equal(fr.attempts, fp.attempts)
        np.testing.assert_array_equal(fr.succeeded, fp.succeeded)
        np.testing.assert_allclose(fp.wastage_gbs, fr.wastage_gbs, rtol=1e-5)


def test_load_fitted_rejects_mismatched_variant(data):
    ref, _ = _fit_both("k-segments-partial", data["bwa"])
    with pytest.raises(ValueError):
        reg_pt.load_fitted("k-segments-partial", state_of(ref),
                           variant="selective", device=CPU)


def test_tune_offset_matches_reference(data):
    mems, dts, inputs = data["bwa"][:3]
    ref = reg_ref.make("ks+", k=4)
    ref.fit(mems, dts, inputs)
    pt = reg_pt.load_fitted("ks+", state_of(ref), device=CPU)
    best_r, tot_r = reg_ref.tune_offset(ref, mems, dts, inputs)
    best_p, tot_p = reg_pt.tune_offset(pt, mems, dts, inputs, device=CPU)
    assert (best_p.peak, best_p.start, best_p.last_peak_bump) == \
        (best_r.peak, best_r.start, best_r.last_peak_bump)
    np.testing.assert_allclose(tot_p, tot_r, rtol=1e-5)
    fams = {f: data[f][:3] for f in FAMILIES[:2]}
    fitted = {f: reg_pt.load_fitted("ks+", state_of(_fit_both("ks+", d)[0]),
                                    device=CPU) for f, d in fams.items()}
    assert set(reg_pt.tune_offset_map(fitted, fams, device=CPU)) == set(fams)


def test_incremental_refit_matches_full_fit(data):
    """Online refit on cached rows == a from-scratch fit on the history."""
    mems, dts, inputs, test_inputs, test_mems = data["dedup"]
    online = reg_pt.make("ks+", device=CPU)
    online.fit(mems, dts, inputs)
    for m, i in zip(test_mems, test_inputs):
        online.observe(ExecutionOutcome(mem=m, dt=1.0, input_gb=i))
    assert online.refit("every_n")
    full = reg_pt.make("ks+", device=CPU)
    full.fit(list(mems) + list(test_mems), list(dts) + [1.0] * len(test_mems),
             list(inputs) + list(test_inputs))
    for a, b in zip(online.predict_packed(np.asarray(test_inputs)),
                    full.predict_packed(np.asarray(test_inputs))):
        np.testing.assert_array_equal(a, b)
