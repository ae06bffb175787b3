"""The whole slice: fit → predict → fleet replay against the reference.

``evaluate_workflow`` over the same seeded eager workflow in both packages
(the port on the CPU) must meet the reference's own engine contract
(``tests/test_fleet.py``, fleet vs oracle): retries and failures per method
exact, total GB·s within rtol 1e-4, per-family GB·s within rtol 1e-4 /
atol 1e-2.  Within the port, online replay with ``refit="never"`` must
reproduce the offline result bitwise.  Scenario names and
``WorkflowTrace`` inputs meet the same contract: a reference scenario
carried into the port, and a scenario the port synthesizes by name (the
reference evaluates the port's trace itself: both take any object with
``to_workflow``).
"""

import numpy as np
import pytest

from repro.sched.simulator import evaluate_workflow as eval_ref
from repro.sched.simulator import run_paper_experiment as paper_ref
from repro.traces import eager as eager_ref
from repro.workloads import scenarios as scen_ref
from repro_torch.sched import evaluate_workflow, run_paper_experiment
from repro_torch.traces import eager
from repro_torch.workloads import load_workflow_trace, scenarios

KW = dict(seed=0, train_frac=0.5, k=4, machine_memory=128.0)


@pytest.fixture(scope="module")
def offline():
    return evaluate_workflow(eager(10), device="cpu", **KW)


def _assert_contract(a_res, b_res):
    assert list(a_res.methods) == list(b_res.methods)
    for m in a_res.methods:
        a, b = a_res.methods[m], b_res.methods[m]
        assert a.retries == b.retries, m
        assert a.failures == b.failures, m
        np.testing.assert_allclose(a.total_gbs, b.total_gbs, rtol=1e-4,
                                   err_msg=m)
        for fam in b.per_family_gbs:
            np.testing.assert_allclose(
                a.per_family_gbs[fam], b.per_family_gbs[fam], rtol=1e-4,
                atol=1e-2, err_msg=f"{m}/{fam}")


def test_matches_reference(offline):
    ref = eval_ref(eager_ref(10), **KW)
    _assert_contract(offline, ref)
    assert set(offline.seconds) == {"fit", "predict", "replay"}


def test_matches_oracle_engine(offline):
    oracle = evaluate_workflow(eager(10), device="cpu", engine="oracle", **KW)
    _assert_contract(offline, oracle)


@pytest.mark.parametrize("round_size", [1, 3])
def test_online_never_equals_offline_bitwise(offline, round_size):
    online = evaluate_workflow(eager(10), device="cpu", mode="online",
                               refit="never", round_size=round_size, **KW)
    for m in offline.methods:
        a, b = offline.methods[m], online.methods[m]
        assert (a.total_gbs, a.retries, a.failures) == \
            (b.total_gbs, b.retries, b.failures), m
        assert a.per_family_gbs == b.per_family_gbs, m


def test_online_refit_runs():
    res = evaluate_workflow(eager(6), device="cpu", mode="online",
                            refit="on_failure", methods=["ks+",
                                                         "tovar-feedback"],
                            **KW)
    for r in res.methods.values():
        assert np.isfinite(r.total_gbs) and r.total_gbs > 0


def test_run_paper_experiment_averages_cells():
    out = run_paper_experiment(eager(6), seeds=[0, 1], train_fracs=(0.5,),
                               methods=["ks+", "default"], device="cpu")
    cells = [evaluate_workflow(eager(6), seed=s, train_frac=0.5,
                               methods=["ks+", "default"], device="cpu")
             for s in (0, 1)]
    for m in ("ks+", "default"):
        assert out[0.5][m] == np.mean([c.methods[m].total_gbs
                                       for c in cells])


def test_scenario_inputs_not_ported_yet():
    """Scenario names and ``WorkflowTrace`` inputs are accepted now, on
    both entry points: a name is its scenario synthesized on the run's
    device with the cell's seed."""
    kw = dict(KW, methods=["default"])
    by_name = evaluate_workflow("heavy_tail", device="cpu", **kw)
    wf = scenarios.get("heavy_tail", seed=0, device="cpu")
    by_trace = evaluate_workflow(wf, device="cpu", **kw)
    assert by_name.methods == by_trace.methods
    out = run_paper_experiment("heavy_tail", seeds=[0], train_fracs=(0.5,),
                               methods=["default"], device="cpu")
    assert out[0.5] == {m: r.total_gbs for m, r in by_name.methods.items()}


SCEN_METHODS = ["ks+", "default"]


def test_scenario_name_matches_reference():
    kw = dict(KW, methods=SCEN_METHODS)
    got = evaluate_workflow("heavy_tail", device="cpu", **kw)
    want = eval_ref(scenarios.get("heavy_tail", seed=0, device="cpu"), **kw)
    _assert_contract(got, want)


def test_carried_trace_matches_reference():
    ref_wf = scen_ref.get("heavy_tail", n_tasks=160, seed=2)
    kw = dict(KW, methods=SCEN_METHODS)
    got = evaluate_workflow(load_workflow_trace(ref_wf, device="cpu"),
                            device="cpu", **kw)
    _assert_contract(got, eval_ref(ref_wf, **kw))


def test_run_paper_experiment_on_scenarios_matches_reference():
    kw = dict(seeds=[0, 1], train_fracs=(0.5,), methods=["ks+", "default"])
    ref_wf = scen_ref.get("heavy_tail", n_tasks=96, seed=1)
    got = run_paper_experiment(load_workflow_trace(ref_wf, device="cpu"),
                               device="cpu", **kw)
    want = paper_ref(ref_wf, **kw)
    for m in kw["methods"]:
        np.testing.assert_allclose(got[0.5][m], want[0.5][m], rtol=1e-4)
    kw = dict(seeds=[3], train_fracs=(0.5,), methods=["default"])
    got = run_paper_experiment("burst_arrival", device="cpu", **kw)
    cells = [eval_ref(scenarios.get("burst_arrival", seed=s, device="cpu"),
                      seed=s, train_frac=0.5, methods=kw["methods"])
             for s in kw["seeds"]]
    for m in kw["methods"]:
        np.testing.assert_allclose(
            got[0.5][m], np.mean([c.methods[m].total_gbs for c in cells]),
            rtol=1e-4)
