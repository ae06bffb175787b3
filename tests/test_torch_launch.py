"""The port's dry run and roofline (``launch/{shapes,mesh,partitioning,
dryrun,roofline}``) against the reference package.

* Every arch × shape: ``cell_supported``, ``cfg_for_cell``, ``step_kind``
  and the shapes and dtypes of ``input_specs`` equal the reference's.
* ``param_specs`` (in the reference's stacked tree, ``tree_specs``) equal
  the reference's declarations, and ``spec_for`` gives the reference's
  spec for every parameter of every arch, and for every cache entry, on
  meshes of shape (16, 16), (2, 16, 16) and (4, 2) (JAX's
  ``AbstractMesh`` against port meshes over a fake process group).
* ``model_flops`` equals the reference's to a relative 1e-12 on all 31
  runnable cells; ``derive_terms`` equals it on synthetic records.
* The LM kernels' custom operators: their fake implementations give the
  plain versions' shapes and dtypes; their FLOP rules give the analytic
  counts; given DTensors the wrappers run them on each shard through
  ``local_map``.
* ``run_cell`` on fake (4, 2) and (2, 2, 2) meshes for the reference's
  tiny-mesh trio at its reduced batch: ``ok``, collective bytes, and a
  per-device peak below the (1, 1) run's.  At (1, 1) a small config's
  dry-run FLOPs equal ``FlopCounterMode`` over the same step, with no
  collectives; full-depth FLOPs equal ``derive_terms``' extrapolation.

The reference's ``launch/dryrun.py`` and ``roofline.py`` set ``XLA_FLAGS``
for 512 host devices when imported: they are imported once JAX's backend
is up, and the variable is restored, so nothing else in the worker sees it.
"""

import dataclasses
import itertools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import partitioning as jpart
from repro.launch import shapes as jshapes
from repro_torch import configs
from repro_torch.kernels import dryrun as kernel_dryrun
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import dryrun, mesh as mesh_mod, partitioning, \
    roofline, shapes
from repro_torch.models import (cache_specs, param_shapes, param_specs,
                                tree_specs)

logging.getLogger("torch.distributed").setLevel(logging.ERROR)


def _reference_launch():
    """The reference's dryrun and roofline modules, imported without
    leaving their ``XLA_FLAGS`` behind."""
    jax.devices()  # the backend is up: the flags change nothing here
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
        from repro.launch import roofline as jroofline
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun, jroofline


CELLS = list(itertools.product(configs.ARCHS, shapes.SHAPES))
_JDTYPE = {torch.int32: "int32", torch.bfloat16: "bfloat16",
           torch.float32: "float32"}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ----------------------------------------------------------------- shapes
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_policy_matches_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert shapes.cell_supported(cfg, shape) \
        == jshapes.cell_supported(jcfg, shape)
    assert dataclasses.asdict(shapes.cfg_for_cell(cfg, shape)) \
        == dataclasses.asdict(jshapes.cfg_for_cell(jcfg, shape))
    assert shapes.step_kind(cfg, shape) == jshapes.step_kind(jcfg, shape)
    if not shapes.cell_supported(cfg, shape)[0]:
        with pytest.raises(ValueError):
            shapes.input_specs(cfg, shape)
        return
    got = dict(_flat(shapes.input_specs(cfg, shape)))
    want = dict(_flat(jshapes.input_specs(jcfg, shape)))
    assert set(got) == set(want)
    for k, spec in got.items():
        assert tuple(spec.shape) == tuple(want[k].shape), k
        assert _JDTYPE[spec.dtype] == str(want[k].dtype), k


def test_cell_counts():
    ok = [c for c in CELLS
          if shapes.cell_supported(configs.get_config(c[0]), c[1])[0]]
    assert (len(CELLS), len(ok)) == (40, 31)


# ------------------------------------------------------------ partitioning
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]


@pytest.fixture(scope="module")
def port_meshes():
    """Port meshes of MESHES' shapes, each over its own fake group (the
    mesh object outlives its group; ``spec_for`` reads only its shape)."""
    out = []
    for shape, names in MESHES:
        with mesh_mod.fake_world():
            out.append(mesh_mod.make_mesh(shape, names))
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_reference(arch):
    cfg = configs.get_config(arch)
    assert tree_specs(cfg) == jmodels.param_specs(jconfigs.get_config(arch))
    assert set(param_specs(cfg)) == set(param_shapes(cfg))


@pytest.mark.parametrize("arch,mesh_i", itertools.product(
    configs.ARCHS, range(len(MESHES))))
def test_spec_for_matches_reference(arch, mesh_i, port_meshes):
    shape, names = MESHES[mesh_i]
    jmesh = AbstractMesh(shape, names)
    mesh = port_meshes[mesh_i]
    jrules, rules = jpart.default_rules(jmesh), \
        partitioning.default_rules(mesh)
    assert rules == jrules
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    jshapes_ = dict(_flat(jmodels.param_shapes(jcfg)))
    jaxes = dict(_flat(jmodels.param_specs(jcfg)))
    shapes_ = param_shapes(cfg)
    from repro_torch.models.model import _ref_path
    for name, axes in param_specs(cfg).items():
        path, idx = _ref_path(cfg, name)
        want = tuple(jpart.spec_for(jaxes[path], jshapes_[path].shape,
                                    jmesh, jrules))
        want = want + (None,) * (len(jshapes_[path].shape) - len(want))
        got = partitioning.spec_for(axes, shapes_[name], mesh, rules)
        assert (None,) * len(idx) + got == want, name
    # the serving cache at the reference dry run's axes
    jdryrun, _ = _reference_launch()
    model_size = dict(zip(names, shape))["model"]
    for name, (cshape, _) in \
            __import__("repro_torch.models", fromlist=["x"]).cache_shapes(
                cfg, 16, 4096).items():
        axes = cache_specs(cfg, model_size)[name]
        assert axes == jdryrun._cache_axes(jcfg, name, len(cshape),
                                           model_size)
        got = partitioning.spec_for(axes, cshape, mesh, rules)
        want = tuple(jpart.spec_for(axes, cshape, jmesh, jrules))
        assert got == want + (None,) * (len(cshape) - len(want)), name


def test_placements_and_constraint_outside_context():
    from torch.distributed.tensor import Replicate, Shard
    with mesh_mod.fake_world():
        mesh = mesh_mod.make_mesh((2, 2, 2), ("pod", "data", "model"))
        spec = (("pod", "data"), None, "model")
        assert partitioning.placements_for(spec, mesh) \
            == [Shard(0), Shard(0), Shard(2)]
        assert partitioning.placements_for((None,), mesh) == [Replicate()] * 3
        assert partitioning.sharding_for(("batch", None), (8, 3), mesh) \
            == (mesh, [Shard(0), Shard(0), Replicate()])
        tree = partitioning.tree_shardings(
            {"a": ("batch", None), "b": {"c": ("vocab", "embed_fsdp")}},
            {"a": (8, 3), "b": {"c": (6, 4)}}, mesh)
        assert tree == {"a": (mesh, [Shard(0), Shard(0), Replicate()]),
                        "b": {"c": (mesh, [Replicate(), Shard(1),
                                           Shard(0)])}}
    x = torch.ones(4, 3)
    assert partitioning.logical_constraint(x, "batch", None) is x
    assert partitioning.current_batch_shards() == 1
    assert partitioning.current_mesh() is None


def test_local_mesh_is_the_process_world():
    """``make_local_mesh`` without a process group: a (1, 1) mesh over a
    one-process group it starts; a production mesh needs a group of its
    size (or a dry run's fake one)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = mesh_mod.make_local_mesh()
        assert tuple(mesh.shape) == (1, 1)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        with pytest.raises(ValueError, match="process group of 1"):
            mesh_mod.make_production_mesh()
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_production_mesh()


# --------------------------------------------------------------- roofline
@pytest.mark.parametrize("arch,shape", [
    c for c in CELLS
    if shapes.cell_supported(configs.get_config(c[0]), c[1])[0]])
def test_model_flops_matches_reference(arch, shape):
    _, jroofline = _reference_launch()
    got = roofline.model_flops(configs.get_config(arch), shape)
    want = jroofline.model_flops(jconfigs.get_config(arch), shape)
    assert got == pytest.approx(want, rel=1e-12)


def _record(rng):
    return {"flops_per_device": float(rng.uniform(1e12, 1e13)),
            "bytes_per_device": float(rng.uniform(1e9, 1e10)),
            "hbm_bytes_per_device": float(rng.uniform(1e9, 1e10)),
            "collective": {"total_bytes": float(rng.uniform(1e6, 1e9))}}


@pytest.mark.parametrize("seed", range(4))
def test_derive_terms_matches_reference(seed):
    _, jroofline = _reference_launch()
    rng = np.random.default_rng(seed)
    full, a, b = (_record(rng) for _ in range(3))
    b["flops_per_device"] += a["flops_per_device"]
    got = roofline.derive_terms(full, a, b, 28, 4)
    want = jroofline.derive_terms(full, a, b, 28, 4)
    assert got == want


def test_mfu_and_link():
    assert roofline.mfu(989e12, 1, 2.0) == pytest.approx(0.5)
    assert roofline._link_bw({"collective": {"group_sizes": [8]}}) \
        == mesh_mod.HW.NVLINK_BW
    assert roofline._link_bw({"collective": {"group_sizes": [2, 16]}}) \
        == mesh_mod.HW.IB_BW


# ------------------------------------------------------- kernels as ops
FLASH = [(2, 64, 64, 8, 2, 16, True, None), (1, 50, 50, 4, 4, 8, False, None),
         (2, 64, 64, 4, 1, 16, True, 16)]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window", FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_fake_and_flops(B, Sq, Skv, H, K, hd, causal, window,
                                 dtype):
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(dtype) for s in ((B, Sq, H, hd), (B, Skv, K, hd),
                                    (B, Skv, K, hd)))
    want, lse = flash_ops.ref.flash_attention_fwd(q, k, v, causal=causal,
                                                  window=window)
    mask = np.ones((Sq, Skv), bool)
    i, j = np.arange(Sq)[:, None], np.arange(Skv)[None]
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    pairs = int(mask.sum())
    assert flash_ops.attended_pairs(Sq, Skv, causal, window) == pairs
    with FakeTensorMode() as mode, kernel_dryrun.dry_run():
        fq, fk, fv = (mode.from_tensor(t).requires_grad_()
                      for t in (q, k, v))
        with FlopCounterMode(display=False) as fc:
            out = flash_ops.flash_attention(fq, fk, fv, causal=causal,
                                            window=window)
            fwd = fc.get_total_flops()
            out.backward(torch.ones_like(out))
        total = fc.get_total_flops()
        assert (out.shape, out.dtype) == (want.shape, want.dtype)
        assert (fq.grad.shape, fk.grad.shape, fv.grad.shape) \
            == (q.shape, k.shape, v.shape)
        o, l2 = torch.ops.repro_torch.flash_attention(fq, fk, fv, causal,
                                                      window, True)
        assert (l2.shape, l2.dtype) == (lse.shape, lse.dtype)
    assert fwd == 4 * hd * B * H * pairs
    assert total == fwd + int(2.5 * fwd)


SSD = [(2, 100, 4, 8, 1, 16), (1, 300, 6, 16, 2, 8)]


@pytest.mark.parametrize("B,S,H,P,G,N", SSD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_op_fake_and_flops(B, S, H, P, G, N, dtype):
    rng = np.random.default_rng(1)
    X, A, Bm, Cm = (torch.as_tensor(rng.standard_normal(s) * 0.3,
                                    dtype=torch.float32).to(dtype)
                    for s in ((B, S, H, P), (B, S, H), (B, S, G, N),
                              (B, S, G, N)))
    y, final = ssd_ops.ref.ssd(X, A, Bm, Cm, 16)
    with FakeTensorMode() as mode, kernel_dryrun.dry_run():
        fx = [mode.from_tensor(t).requires_grad_() for t in (X, A, Bm, Cm)]
        with FlopCounterMode(display=False) as fc:
            fy, ff = ssd_ops.ssd(*fx, 16)
            fwd = fc.get_total_flops()
            (fy.float().sum() + ff.sum()).backward()
        total = fc.get_total_flops()
        assert (fy.shape, fy.dtype, ff.shape, ff.dtype) \
            == (y.shape, y.dtype, final.shape, final.dtype)
        assert [t.grad.shape for t in fx] == [t.shape for t in (X, A, Bm, Cm)]
        _, _, s_in, cum = torch.ops.repro_torch.ssd(*fx)
        nc = -(-S // 256) if dtype == torch.bfloat16 else 0
        assert s_in.shape == (B, nc, H, 2, P, N) and cum.shape == (B, H, nc,
                                                                   256)
    T = 64
    want = B * H * -(-S // T) * (T * (T + 1) * (N + P) + 4 * T * P * N)
    assert fwd == want == ssd_ops.flops(B, S, H, P, N)
    assert total == 3 * want


def test_kernels_shard_through_local_map():
    """Given DTensors, ``flash_attention`` and ``ssd`` run the operators on
    each device's shard through ``local_map``: batch-sharded inputs stay
    batch-sharded; heads shard where the mesh axis divides the KV heads or
    the groups, else each shard slices out the KV heads it reads (GQA) or
    the SSD heads stay whole."""
    with mesh_mod.fake_world():
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
        with FakeTensorMode(), kernel_dryrun.dry_run():
            _shard_kernels(mesh)


def _shard_kernels(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def dt(shape, pl):
        local = [s // (2 if any(p == Shard(d) for p in pl) else 1)
                 for d, s in enumerate(shape)]
        return DTensor.from_local(torch.empty(local, dtype=torch.bfloat16),
                                  mesh, pl, shape=torch.Size(shape),
                                  stride=torch.empty(shape).stride(),
                                  run_check=False)
    heads = [Shard(0), Shard(2)]
    batch = [Shard(0), Replicate()]
    q = dt((4, 32, 8, 16), heads)
    for K, kv_pl in ((4, heads), (1, batch)):
        k, v = dt((4, 32, K, 16), kv_pl), dt((4, 32, K, 16), kv_pl)
        out = flash_ops.flash_attention(q, k, v, causal=True)
        assert tuple(out.placements) == (Shard(0), Shard(2))
        assert out.to_local().shape == (2, 32, 4, 16)
    X, A = dt((4, 64, 8, 16), heads), dt((4, 64, 8), heads)
    for G, pl, H_local in ((2, heads, 4), (1, batch, 8)):
        Bm = dt((4, 64, G, 16), pl)
        y, final = ssd_ops.ssd(X, A, Bm, Bm, 16)
        assert tuple(y.placements) == tuple(pl)
        assert y.to_local().shape == (2, 64, H_local, 16)
        assert final.to_local().shape == (2, H_local, 16, 16)


# ----------------------------------------------------------------- dry run
TRIO = [("qwen3-1.7b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
        ("mamba2-780m", "long_500k")]


@pytest.mark.parametrize("arch,shape", TRIO)
def test_run_cell_on_tiny_meshes(arch, shape, tmp_path, monkeypatch):
    """The reference's ``TestDryRunTinyMesh``: the production mesh swapped
    for (4, 2) and (2, 2, 2), the global batch shrunk."""
    monkeypatch.setattr(mesh_mod, "make_production_mesh",
                        lambda multi_pod=False: mesh_mod.make_mesh(
                            (2, 2, 2) if multi_pod else (4, 2),
                            ("pod", "data", "model") if multi_pod
                            else ("data", "model")))
    cell = shapes.SHAPES[shape]
    cell = dataclasses.replace(cell, batch=max(cell.batch // 32, 4))
    one = dryrun.run_cell(arch, cell, False, out_dir=str(tmp_path),
                          mesh_shape=(1, 1))
    assert one["status"] == "ok" and one["collective"]["total_bytes"] == 0
    for multi in (False, True):
        rec = dryrun.run_cell(arch, cell, multi, out_dir=str(tmp_path))
        assert rec["status"] == "ok", rec
        assert rec["n_devices"] == 8
        assert rec["collective"]["total_bytes"] > 0
        assert 0 < rec["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]
        assert rec["flops_per_device"] > 0
        assert os.path.exists(tmp_path / (rec["cell"] + ".json"))


@pytest.mark.parametrize("arch,shape", [("zamba2-2.7b", "train_4k"),
                                        ("olmoe-1b-7b", "prefill_32k"),
                                        ("qwen3-1.7b", "decode_32k")])
def test_one_device_flops_equal_flop_counter(arch, shape, tmp_path):
    """At (1, 1) the dry run's FLOPs are ``FlopCounterMode``'s over the
    same step (fake tensors, the kernels' operators), with no
    collectives."""
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import step_fn_for
    cfg = configs.smoke_config(arch)
    cell = dataclasses.replace(shapes.SHAPES[shape], batch=2,
                               seq=min(shapes.SHAPES[shape].seq, 64))
    rec = dryrun.run_cell(arch, cell, False, out_dir=str(tmp_path),
                          cfg_override=cfg, mesh_shape=(1, 1))
    assert rec["collective"]["total_bytes"] == 0
    assert rec["collective"]["counts"] == {}
    specs = shapes.input_specs(cfg, cell)
    kind = shapes.step_kind(cfg, cell)

    def make(tree):
        return {k: make(v) if isinstance(v, dict)
                else torch.zeros(v.shape, dtype=v.dtype)
                for k, v in tree.items()}
    with FakeTensorMode(), kernel_dryrun.dry_run():
        model = Model(cfg, None, torch.device("cpu"))
        if kind != "train":
            model = model.to(getattr(torch, cfg.dtype))
        args = make(specs)
        with FlopCounterMode(display=False) as fc:
            if kind == "train":
                step_fn_for(cfg, kind)(model, adamw_init(dict(
                    model.named_parameters())), args["batch"], 1)
            elif kind == "decode":
                step_fn_for(cfg, kind)(model, args["batch"], args["cache"],
                                       args["pos"])
            else:
                step_fn_for(cfg, kind)(model, args["batch"])
    assert rec["flops_per_device"] == fc.get_total_flops() > 0


@pytest.mark.parametrize("arch,layers", [("qwen3-1.7b", 6),
                                         ("zamba2-2.7b", 6)])
def test_full_depth_equals_derive_terms(arch, layers, tmp_path):
    """The step runs layer by layer, so a full-depth count needs no
    extrapolation; the reference's pair reproduces it exactly."""
    base = dataclasses.replace(configs.smoke_config(arch), n_layers=layers)
    cell = dataclasses.replace(shapes.SHAPES["train_4k"], batch=8, seq=32)
    # the reference's pair: 4 layers, or 2 super-layers of a hybrid
    every = base.shared_attn_every if base.family == "hybrid" else 1
    L_red = 2 if base.family == "hybrid" else 4
    runs = [dryrun.run_cell(arch, cell, False, out_dir=str(tmp_path),
                            cfg_override=dataclasses.replace(
                                base, n_layers=n * every),
                            tag=f"L{n}", mesh_shape=(4, 2))
            for n in (1, L_red)]
    full = dryrun.run_cell(arch, cell, False, out_dir=str(tmp_path),
                           cfg_override=base, mesh_shape=(4, 2))
    L = layers // every
    terms = roofline.derive_terms(full, runs[0], runs[1], L, L_red)
    assert terms["flops"] == pytest.approx(full["flops_per_device"],
                                           rel=1e-12)
    rec = roofline.roofline_terms(full, base, cell)
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["compute_s"] == full["flops_per_device"] \
        / mesh_mod.HW.PEAK_FLOPS_BF16
