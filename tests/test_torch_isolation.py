"""The port stands alone, and never drops silently to the CPU.

* No module under ``src/repro_torch/`` (nor ``chip_smoke.py``) imports
  ``jax`` or the reference package ``repro``.
* Entry points called without ``device`` mean the card: without CUDA they
  raise instead of running on the CPU.
* A CPU tensor takes the plain version of a kernel and counts no launch.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import registry
from repro_torch.core.fleet import bucket_traces, simulate_fleet
from repro_torch.device import resolve_device
from repro_torch.kernels.wastage import ops
from repro_torch.sched import evaluate_workflow, run_paper_experiment
from repro_torch.traces import eager

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


ENTRY_POINTS = {
    "bucket_traces": lambda: bucket_traces([np.ones(4)]),
    "simulate_fleet": lambda: simulate_fleet(
        (np.zeros((1, 1), np.float32), np.ones((1, 1), np.float32),
         np.ones(1, np.int32)), "double", [np.ones(4)]),
    "registry.make": lambda: registry.make("ks+"),
    "evaluate_workflow": lambda: evaluate_workflow(
        eager(3), seed=0, train_frac=0.5, methods=["default"]),
    "run_paper_experiment": lambda: run_paper_experiment(
        eager(3), seeds=[0], train_fracs=(0.5,), methods=["default"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_cpu_tensor_counts_no_launch():
    rng = np.random.default_rng(0)
    args = (torch.zeros((4, 2)), torch.ones((4, 2)),
            torch.from_numpy(rng.uniform(0, 2, (4, 16)).astype(np.float32)),
            torch.full((4,), 16, dtype=torch.int32))
    before = dict(ops.LAUNCHES)
    ops.oom_probe(*args)
    ops.wastage_eval(*args)
    assert ops.LAUNCHES == before
