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


def test_lint_and_drain_modules_are_covered():
    """The import check above reads the lint's modules too."""
    port = ROOT / "src" / "repro_torch"
    names = {p.relative_to(port).as_posix() for p in FILES
             if p.is_relative_to(port)}
    assert {"analysis/lint.py", "analysis/rules.py", "analysis/model.py",
            "analysis/__main__.py", "sched/admission.py",
            "launch/train.py"} <= names


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
    "models.init_params(moe)": lambda: init_params(
        smoke_config("olmoe-1b-7b"), torch.Generator()),
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
    "sched.AdmissionState(shard=1)": lambda: AdmissionState(
        [1.0], K=1, G=4, shard=1),
    "sched.ElasticPlanner": lambda: ElasticPlanner(backend="fused"),
    "sched.HBMFootprintModel": lambda: HBMFootprintModel(),
    "serve.PredictionServer": lambda: PredictionServer(),
    "serve.TenantRegistry": lambda: TenantRegistry(),
    "serve.bench.run_saturation": lambda: run_saturation(
        tenants=1, n_requests=8),
    "launch.serve.serve_demo": lambda: serve_demo("qwen3-1.7b",
                                                  requests=1),
    "launch.serve.serve_demo(vlm)": lambda: serve_demo("qwen2-vl-72b",
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


LAUNCH_MODULES = ["launch/shapes.py", "launch/mesh.py",
                  "launch/partitioning.py", "launch/dryrun.py",
                  "launch/roofline.py", "kernels/dryrun.py"]


@pytest.mark.parametrize("rel", LAUNCH_MODULES)
def test_dry_run_modules_are_checked(rel):
    """The dry run and roofline modules are among the files held to no
    ``jax`` / ``repro`` import above."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in FILES
    assert not {m.split(".")[0] for m in _imports(path)} & {
        "jax", "jaxlib", "repro"}


def test_dry_run_never_takes_the_plain_attention(tmp_path, monkeypatch):
    """Inside a dry run the LM kernels' wrappers call their operators
    (fake implementations) whatever the fake tensors' device: the plain
    versions, the dense S x S attention among them, are never reached,
    on one device and on a mesh."""
    import dataclasses

    from repro_torch.launch import dryrun, shapes

    def refuse(*a, **kw):
        raise AssertionError("a dry run reached a plain version")
    for mod, names in ((flash_ops.ref, ("flash_attention",
                                        "flash_attention_fwd",
                                        "flash_attention_bwd")),
                       (ssd_ops.ref, ("ssd", "ssd_bwd"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    cell = dataclasses.replace(shapes.SHAPES["train_4k"], batch=4, seq=32)
    for mesh in ((1, 1), (2, 2)):
        rec = dryrun.run_cell("zamba2-2.7b", cell, False,
                              out_dir=str(tmp_path),
                              cfg_override=smoke_config("zamba2-2.7b"),
                              mesh_shape=mesh)
        assert rec["status"] == "ok"
    with pytest.raises(AssertionError, match="plain version"):
        flash_ops.flash_attention(*(torch.zeros(1, 4, 2, 8)
                                    for _ in range(3)))


def _run_model(cfg, seed=0):
    """Prefill, two decode steps and one training loss with its gradients
    of a smoke model on the CPU."""
    from repro_torch.models import decode_step, forward_train, prefill
    model = init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=g,
                         dtype=torch.int32)
    logits, cache = prefill(model, cfg, {"tokens": toks}, capacity=14)
    outs = [logits]
    for t in range(2):
        pos = torch.full((2,), 12 + t, dtype=torch.int32)
        logits, cache = decode_step(model, cfg, {"tokens": toks[:, t]},
                                    cache, pos)
        outs.append(logits)
    loss, _ = forward_train(model, cfg, {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return outs + list(cache.values()) + [loss] + list(grads)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b",
                                  "olmoe-1b-7b"])
def test_partitioning_sites_are_no_ops_outside_a_mesh(arch, monkeypatch):
    """The ``logical_constraint`` and ``gathered`` sites in the models
    change nothing outside a mesh context (or inside a one-device one):
    the outputs, caches, loss and gradients are bitwise those of the
    models with every site replaced by the identity and a plain cast."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import partitioning
    from repro_torch.models import blocks, layers, mamba2, model, moe
    cfg = smoke_config(arch)
    got = _run_model(cfg)
    with mesh_mod.fake_world():
        with partitioning.mesh_context(mesh_mod.make_mesh(
                (1, 1), ("data", "model"))):
            in_mesh = _run_model(cfg)
    for mod in (blocks, layers, mamba2, model, moe):
        if hasattr(mod, "logical_constraint"):
            monkeypatch.setattr(mod, "logical_constraint",
                                lambda x, *axes: x)
        if hasattr(mod, "gathered"):
            monkeypatch.setattr(mod, "gathered", lambda w, dt: w.to(dt))
    want = _run_model(cfg)
    assert len(got) == len(want) == len(in_mesh)
    for a, b, c in zip(got, want, in_mesh):
        assert torch.equal(a, b) and torch.equal(c, b)
