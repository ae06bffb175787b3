"""The fused admission and the cluster replay on the card against the
same on the CPU: placements and admission times exact, fits equal and
minimum residuals within 1e-12 relative, and replays held to
``_assert_same`` (integer outputs and the makespan exact, wastage,
utilization and starvation within rtol 1e-6).  ``tests/test_torch_sched.py``
holds the CPU side against the reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import RetrySpec
from repro_torch.kernels.wastage import ops
from repro_torch.sched import AdmissionState, ClusterSim
from repro_torch.workloads import load_workflow_trace
from torch_cases import _assert_same, _lanes, _nodes

CPU = "cpu"


@pytest.mark.cuda
class TestOnCard:
    def test_fused_admission_card_matches_cpu(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        for select in ("first", "headroom"):
            rng = np.random.default_rng(7)
            lanes = _lanes(rng, 300, 3, 16, select == "first")
            states = [AdmissionState((48.0, 64.0, 32.0, 96.0), K=3, G=16,
                                     use_dur=select == "first", device=d)
                      for d in ("cuda", CPU)]
            for st in states:
                st.add_lanes(*lanes)
            for now, q in ((0.0, range(4)), (5.0, range(4, 300))):
                card, cpu = (st.drain(now, list(q), select=select)
                             for st in states)
                assert card == cpu
            np.testing.assert_array_equal(
                states[0].columns(9.0, list(range(300))),
                states[1].columns(9.0, list(range(300))))
            np.testing.assert_allclose(states[0].minresid,
                                       states[1].minresid, rtol=1e-12)

    def test_cluster_fused_card_matches_cpu(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        from repro_torch.workloads import scenarios, trace_state
        wf = scenarios.get("workload_replay", n_tasks=200, seed=0,
                           device="cuda")
        cpu_wf = load_workflow_trace(trace_state(wf), device=CPU)
        before = ops.LAUNCHES["oom_probe"]
        card = ClusterSim(_nodes(), device="cuda").run(
            wf.to_jobs(under_frac=0.2), RetrySpec("ksplus"))
        assert ops.LAUNCHES["oom_probe"] == before + 1
        cpu = ClusterSim(_nodes(), device=CPU).run(
            cpu_wf.to_jobs(under_frac=0.2), RetrySpec("ksplus"))
        _assert_same(card, cpu)
