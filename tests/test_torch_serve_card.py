"""The prediction service on the card against the same server on the CPU:
served plans within rtol/atol 1e-5, ``evaluate`` with ``succeeded`` and
``mean_attempts`` exact and ``total_gbs`` within rtol 1e-4, ``tune_offset``
with the same best candidate, and one ``fleet_engine`` launch per
evaluate and per tune group.  ``tests/test_torch_serve.py`` holds the CPU
server against the reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.serve.bench import FAMILIES, build_server, request_tape
from torch_cases import FIT_TOL, GBS_RTOL, _served

CPU = "cpu"


@pytest.mark.cuda
def test_server_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("the fleet_engine kernel has no CPU mode; needs a card")
    from repro_torch.kernels.wastage import ops
    card = build_server(tenants=2, seed=0, device="cuda")
    cpu = build_server(tenants=2, seed=0, device=CPU)
    tape = request_tape(64, 2, seed=5)
    for a, b in zip(_served(card, tape), _served(cpu, tape)):
        np.testing.assert_allclose(a.starts, b.starts, **FIT_TOL)
        np.testing.assert_allclose(a.peaks, b.peaks, **FIT_TOL)
    before = ops.LAUNCHES["fleet_engine"]
    for family, _ in FAMILIES:
        got = card.client("tenant0").evaluate(family)
        want = cpu.client("tenant0").evaluate(family)
        assert (got.succeeded, got.mean_attempts) == (want.succeeded,
                                                      want.mean_attempts)
        np.testing.assert_allclose(got.total_gbs, want.total_gbs,
                                   rtol=GBS_RTOL)
        got = card.client("tenant1").tune_offset(family)
        want = cpu.client("tenant1").tune_offset(family)
        assert got.best == want.best
        np.testing.assert_allclose(got.totals, want.totals, rtol=GBS_RTOL)
    # one launch per evaluate and one per tune group
    assert ops.LAUNCHES["fleet_engine"] - before == 2 * len(FAMILIES)
