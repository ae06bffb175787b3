"""The whole slice: fit → predict → fleet replay against the reference.

``evaluate_workflow`` over the same seeded eager workflow in both packages
(the port on the CPU) must meet the reference's own engine contract
(``tests/test_fleet.py``, fleet vs oracle): retries and failures per method
exact, total GB·s within rtol 1e-4, per-family GB·s within rtol 1e-4 /
atol 1e-2.  Within the port, online replay with ``refit="never"`` must
reproduce the offline result bitwise.
"""

import numpy as np
import pytest

from repro.sched.simulator import evaluate_workflow as eval_ref
from repro.traces import eager as eager_ref
from repro_torch.sched import evaluate_workflow, run_paper_experiment
from repro_torch.traces import eager

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
    with pytest.raises(NotImplementedError, match="A7"):
        evaluate_workflow("heavy_tail", device="cpu", **KW)
