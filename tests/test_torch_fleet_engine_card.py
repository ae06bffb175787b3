"""The ``fleet_engine`` kernel and the grouped probes on the card.

The engine against the plain engine (``kernels.wastage.ref.plain_engine``)
on the same CUDA group table: attempts and successes exact, wastage within
rtol 1e-4 (the reference's ``test_fleet`` tolerance: the retried lanes'
trace sums are reduced in another order).  The grouped probes against
one-group calls, bitwise.  ``tests/test_torch_fleet_engine.py`` holds the
plain engine and an emulation of the kernel's design on the CPU.
"""

import numpy as np
import pytest
import torch

import repro_torch.core.fleet as f_pt
from repro_torch.kernels.wastage import ops, ref
from torch_cases import WTOL, F, _groups, _sweep

SWEEP = _sweep()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("name", list(SWEEP))
    def test_fleet_engine_matches_plain_engine(self, name):
        _need_card()
        jobs, mems, dt, mm, n = SWEEP[name]
        table, _ = f_pt._engine_table(
            jobs, f_pt.bucket_traces(mems, device="cuda"))
        before = ops.LAUNCHES["fleet_engine"]
        got = ops.fleet_engine(table, mm, dt, n).cpu().numpy()
        assert ops.LAUNCHES["fleet_engine"] == before + 1
        want = ref.plain_engine(table, mm, dt, n).numpy()
        np.testing.assert_array_equal(got[1:], want[1:])
        np.testing.assert_allclose(got[0].view(F), want[0].view(F), **WTOL)

    @pytest.mark.parametrize("dt", [0.5, 1.0, 2.5])
    def test_grouped_probe_matches_one_group_calls(self, dt):
        """Both grouped probes, one launch each over three groups of
        different K and T, equal to one-group calls of the same kernels."""
        _need_card()
        groups = [ops.Group(torch.from_numpy(g.starts).cuda(),
                            torch.from_numpy(g.peaks).cuda(), g.mems.cuda(),
                            g.lengths.cuda()) for g in _groups(51)]
        table = ops.GroupTable(groups, "cuda")
        before = dict(ops.LAUNCHES)
        viol, ws, wk = ops.oom_probe_groups(table, dt)
        we = ops.wastage_eval_groups(table, dt)
        assert ops.LAUNCHES["oom_probe"] == before["oom_probe"] + 1
        assert ops.LAUNCHES["wastage_eval"] == before["wastage_eval"] + 1
        for g, lo in zip(groups, table.lane0):
            args = (g.starts, g.peaks, g.mems[:g.B].contiguous(),
                    g.lengths[:g.B].contiguous())
            v, s, k = ops.oom_probe(*args, dt=dt)
            assert torch.equal(viol[lo:lo + g.B], v)
            torch.testing.assert_close(ws[lo:lo + g.B], s, rtol=0, atol=0)
            torch.testing.assert_close(wk[lo:lo + g.B], k, rtol=0, atol=0)
            torch.testing.assert_close(we[lo:lo + g.B],
                                       ops.wastage_eval(*args, dt=dt),
                                       rtol=0, atol=0)
