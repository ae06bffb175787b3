"""The wastage kernels (``oom_probe``, ``wastage_eval``) on the card
against their plain versions on the same CUDA tensors: ``viol`` exact,
``w_succ`` / ``w_kill`` and the wastage within rtol 1e-4 / atol 1e-2 (the
reference tests' tolerance: float32 sums in another order).

The kernels have no CPU mode, so every test here is ``cuda``-marked and
skips without a card; the plain versions are held to the reference in
``tests/test_torch_kernels.py``.
"""

import pytest
import torch

from repro_torch.kernels.wastage import ops, ref
from torch_cases import PROBE_TOL, _probe_cases, _torch

PROBES = _probe_cases()


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("name", list(PROBES))
    def test_kernel_matches_plain(self, name):
        if not torch.cuda.is_available():
            pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")
        *arrs, dt = PROBES[name]
        arrs = tuple(t.cuda() for t in _torch(*arrs))
        before = ops.LAUNCHES["oom_probe"]
        viol, ws, wk = ops.oom_probe(*arrs, dt=dt)
        assert ops.LAUNCHES["oom_probe"] == before + 1
        rv, rs, rk = ref.oom_probe(*arrs, dt)
        assert torch.equal(viol, rv)
        torch.testing.assert_close(ws, rs, **PROBE_TOL)
        torch.testing.assert_close(wk, rk, **PROBE_TOL)
        torch.testing.assert_close(ops.wastage_eval(*arrs, dt=dt),
                                   ref.wastage_eval(*arrs, dt), **PROBE_TOL)
