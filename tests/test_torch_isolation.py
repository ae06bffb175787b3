"""The port stands alone, and never drops silently to the CPU.

* No module under ``src/repro_torch/`` (nor ``chip_smoke.py``) imports
  ``jax`` or the reference package ``repro``.
* Entry points called without ``device`` mean the card: without CUDA they
  raise instead of running on the CPU.
* A CPU tensor takes the plain version of a kernel and counts no launch
  (wastage, SSD and flash attention).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import registry
from repro_torch.core.fleet import bucket_traces, simulate_fleet
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.wastage import ops
from repro_torch.launch.serve import serve_demo
from repro_torch.launch.train import train
from repro_torch.models import init_cache, init_params, load_jax_params
from repro_torch.sched import (
    AdmissionState,
    ClusterSim,
    ElasticPlanner,
    HBMFootprintModel,
    Node,
    evaluate_workflow,
    run_paper_experiment,
)
from repro_torch.serve import PredictionServer, TenantRegistry
from repro_torch.serve.bench import run_saturation
from repro_torch.traces import eager
from repro_torch.workloads import (
    FamilyRecipe,
    load_instance,
    load_workflow_trace,
    make_suite,
    run_suite,
    scenarios,
    synthesize,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WFC = ROOT / "tests" / "data" / "mini_wfcommons.json"
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
    "models.init_params": lambda: init_params(
        smoke_config("zamba2-2.7b"), torch.Generator()),
    "models.load_jax_params": lambda: load_jax_params(
        smoke_config("mamba2-780m"), {}),
    "models.init_cache": lambda: init_cache(
        smoke_config("zamba2-2.7b"), 1, 8),
    "workloads.synthesize": lambda: synthesize([FamilyRecipe("a")], 2),
    "workloads.scenarios.get": lambda: scenarios.get("heavy_tail",
                                                     n_tasks=8),
    "workloads.load_workflow_trace": lambda: load_workflow_trace(
        scenarios.get("heavy_tail", n_tasks=8, device="cpu")),
    "workloads.load_instance": lambda: load_instance(WFC),
    "workloads.run_suite": lambda: run_suite(
        make_suite(("deep_chain",), ("none",), ("none",)), n_tasks=8),
    "evaluate_workflow(scenario)": lambda: evaluate_workflow(
        "heavy_tail", seed=0, train_frac=0.5, methods=["default"]),
    "sched.ClusterSim": lambda: ClusterSim([Node(0, 8.0)]),
    "sched.AdmissionState": lambda: AdmissionState([1.0], K=1, G=4),
    "sched.ElasticPlanner": lambda: ElasticPlanner(backend="fused"),
    "sched.HBMFootprintModel": lambda: HBMFootprintModel(),
    "serve.PredictionServer": lambda: PredictionServer(),
    "serve.TenantRegistry": lambda: TenantRegistry(),
    "serve.bench.run_saturation": lambda: run_saturation(
        tenants=1, n_requests=8),
    "launch.serve.serve_demo": lambda: serve_demo("qwen3-1.7b",
                                                  requests=1),
    "launch.train.train": lambda: train("qwen3-1.7b", steps=1,
                                        monitor=False),
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


def test_cpu_tensors_count_no_lm_kernel_launch():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 8, generator=g) for _ in range(3))
    X = torch.randn(1, 16, 2, 8, generator=g)
    A = -torch.rand(1, 16, 2, generator=g)
    Bm, Cm = (torch.randn(1, 16, 1, 4, generator=g) for _ in range(2))
    before = (dict(flash_ops.LAUNCHES), dict(ssd_ops.LAUNCHES))
    flash_ops.flash_attention(q, k, v)
    ssd_ops.ssd(X, A, Bm, Cm, 8)
    assert (flash_ops.LAUNCHES, ssd_ops.LAUNCHES) == before


def test_cpu_backward_counts_no_lm_kernel_launch():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
               for _ in range(3))
    X = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    A = (-torch.rand(1, 16, 2, generator=g)).requires_grad_()
    Bm, Cm = (torch.randn(1, 16, 1, 4, generator=g, requires_grad=True)
              for _ in range(2))
    before = (dict(flash_ops.LAUNCHES), dict(ssd_ops.LAUNCHES))
    flash_ops.flash_attention(q, k, v).sum().backward()
    ssd_ops.ssd(X, A, Bm, Cm, 8)[0].sum().backward()
    assert q.grad is not None and X.grad is not None
    assert (flash_ops.LAUNCHES, ssd_ops.LAUNCHES) == before
