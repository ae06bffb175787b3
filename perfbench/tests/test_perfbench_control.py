"""On the card: the control (the reference in float8 put in the program's
place) fails the cell's limits at the cell's own size, and the program
passes them, on one seed.  Skips without a card.

  python -m pytest -q -m cuda perfbench/tests   (from the repo root, on the card)
"""

from pathlib import Path

import pytest
import torch

from perfbench import control, harness
from perfbench.reference.common import no_tf32

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.manifest(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    no_tf32()
    ctx = harness.context(ROOT, cell, 2 ** 31 + 2024, 30.0, "cuda")
    out = control.readings(ctx)
    limits = ctx.limits
    assert all(out["program"][k] <= lim for k, lim in limits.items()), out
    assert any(out["control"][k] > lim for k, lim in limits.items()), out
