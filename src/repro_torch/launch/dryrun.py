"""Dry run: every (arch × shape × mesh) cell's step, traced per device.

Counterpart of the reference's ``launch/dryrun.py``.  For each cell this
builds the mesh (a fake process group of the mesh's size, whose
collectives move nothing), the partitioning rules, the parameters as
DTensors laid out by ``models.param_specs`` (float32 masters and AdamW
moments for ``train``; ``cfg.dtype`` for serving, or ``param_dtype``) and
the inputs laid out by the batch and cache axes, all fake tensors.  It runs
``runtime.step_fn_for(cfg, kind)`` once under ``FakeTensorMode``, a mesh
context and ``kernels.dryrun.dry_run()``, and counts what one device does.
DTensor turns each global operation into the local operations of one
device, and the counter sees those:

* ``flops_per_device`` — ``torch.utils.flop_counter``'s rules on the local
  shapes (the LM kernels' custom operators count with their own rules);
* ``hbm_bytes_per_device`` — the counterpart of the reference's
  ``parse_hbm_bytes``: the output bytes of every local operation that
  allocates, times 2 (written once, read about once); views and aliases
  count nothing, an in-place operation its output, a kernel operator its
  own reads and writes (``io_bytes``); ``bytes_per_device`` the inputs
  and outputs of every operation (XLA's raw "bytes accessed");
* ``memory`` — live local tensors (their storages) before the step
  (``argument_bytes``) and at their peak during it (``peak_bytes``,
  with the kernels' scratch at their launch);
* ``collective`` — every ``_c10d_functional`` collective DTensor issues,
  with its group size, under the reference's ring accounting:
  all-gather × 1, all-reduce × 2, reduce-scatter × group, all-to-all × 1.

The step runs layer by layer in Python, so every layer is counted: the
reference's depth-reduction pair is not needed for totals
(``roofline.derive_terms`` keeps it for parity).  DTensor on a CPU-typed
mesh (the dry run's) sends an all-to-all as an all-gather and a chunk, so
a re-sharding that needs one is counted as an all-gather.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Optional, Sequence
from unittest import mock

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import dryrun as kernel_dryrun
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba2_mix import ops as mix_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.partitioning import (default_rules, mesh_context,
                                             placements_for, spec_for)
from repro_torch.launch.shapes import (SHAPES, ShapeCell, cell_supported,
                                       cfg_for_cell, input_specs, step_kind)
from repro_torch.models import Model, cache_specs, param_specs
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import step_fn_for

__all__ = ["run_cell", "trace_step", "DeviceCounter", "COLLECTIVES",
           "main"]

_BATCH_AXES = {1: ("batch",), 2: ("batch", None), 3: ("batch", None, None)}

# funcol operator → (the reference's name, ring factor or None = group)
COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1.0),
    "all_reduce": ("all-reduce", 2.0),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "all_to_all_single": ("all-to-all", 1.0),
}
_FREE = frozenset({"wait_tensor", "empty", "empty_strided", "empty_like",
                   "new_empty", "new_empty_strided", "detach", "alias",
                   "lift_fresh"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _kernel_io(func, args) -> Optional[int]:
    """A kernel operator's own reads and writes (``ops.io_bytes``)."""
    pkt = func._overloadpacket
    if pkt is torch.ops.repro_torch.flash_attention:
        q, k = args[0], args[1]
        B, Sq, H, hd = q.shape
        return flash_ops.io_bytes(B, Sq, k.shape[1], H, k.shape[2], hd,
                                  q.element_size(), with_lse=args[5])
    if pkt is torch.ops.repro_torch.flash_attention_bwd:
        q, k = args[0], args[1]
        B, Sq, H, hd = q.shape
        return flash_ops.io_bytes(B, Sq, k.shape[1], H, k.shape[2], hd,
                                  q.element_size(), backward=True)
    if pkt is torch.ops.repro_torch.decode_attention:
        q, k = args[0], args[1]
        B, _, H, hd = q.shape
        return decode_ops.io_bytes(B, k.shape[1], H, k.shape[2], hd,
                                   q.element_size(),
                                   append=args[6] is not None)
    if pkt in (torch.ops.repro_torch.ssd, torch.ops.repro_torch.ssd_bwd):
        X, Bm = args[0], args[2]
        B, S, H, P = X.shape
        return ssd_ops.io_bytes(B, S, H, P, Bm.shape[2], Bm.shape[3],
                                X.element_size(),
                                backward=pkt is torch.ops.repro_torch.ssd_bwd)
    if pkt is torch.ops.repro_torch.mamba2_mix_in:
        zx, dt_bias, d_inner, groups, state = (args[0], args[3], *args[5:8])
        B, S, _ = zx.shape
        return mix_ops.io_bytes(B, S, d_inner, dt_bias.shape[0], groups,
                                state, "mix_in", zx.element_size())
    if pkt is torch.ops.repro_torch.mamba2_mix_out:
        Y = args[0]
        B, S, H, P = Y.shape
        return mix_ops.io_bytes(B, S, H * P, H, 1, 1, "mix_out",
                                Y.element_size())
    return None


def _kernel_scratch(func, args) -> int:
    pkt = func._overloadpacket
    if pkt is torch.ops.repro_torch.flash_attention_bwd:
        B, Sq, H, _ = args[0].shape
        return flash_ops.bwd_scratch_bytes(B, Sq, H)
    if pkt is torch.ops.repro_torch.decode_attention:
        q, k = args[0], args[1]
        B, _, H, hd = q.shape
        return decode_ops.scratch_bytes(B, H, k.shape[2], k.shape[1], hd)
    if pkt in (torch.ops.repro_torch.ssd, torch.ops.repro_torch.ssd_bwd):
        X, Bm = args[0], args[2]
        B, S, H, P = X.shape
        bwd = pkt is torch.ops.repro_torch.ssd_bwd
        return ssd_ops.scratch_bytes(B, S, H, P, Bm.shape[3], X.dtype,
                                     backward=bwd,
                                     have_states=bwd and args[6] is not None)
    return 0


class DeviceCounter(TorchDispatchMode):
    """Counts one device's local operations: FLOPs, HBM bytes, bytes
    accessed, collectives, and live tensor bytes (storages, freed when
    PyTorch frees them).  Operations on DTensors pass through to DTensor
    (``NotImplemented``), which issues the local operations counted here."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.paused = False
        self._seen: "weakref.WeakSet" = weakref.WeakSet()
        self.reset()

    @contextlib.contextmanager
    def pause(self):
        """Count nothing inside: DTensor's sharding propagation runs each
        new operation once on global fake tensors to learn its output's
        shape, which no device computes."""
        prev, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = prev

    @contextlib.contextmanager
    def around_propagation(self):
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def meta(prop, op_schema):
            with self.pause():
                return orig(prop, op_schema)
        with mock.patch.object(ShardingPropagator,
                               "_propagate_tensor_meta_non_cached", meta):
            yield

    def reset(self) -> None:
        self.flops = 0
        self.hbm_bytes = 0
        self.bytes_accessed = 0
        self.n_ops = 0
        self.per_op: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.coll_bytes = 0.0
        self.groups = set()
        self.peak = self.live

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, t) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self.paused:
            return func(*args, **kwargs)
        scratch = _kernel_scratch(func, args)
        self.peak = max(self.peak, self.live + scratch)
        out = func(*args, **kwargs)
        self.n_ops += 1
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name != "wait_tensor":
            self._collective(name, args, outs)
            return out
        rule = flop_registry.get(func._overloadpacket)
        if rule is not None:
            self.flops += rule(*args, **kwargs, out_val=out)
        if name in _FREE or func.is_view:
            return out
        io = _kernel_io(func, args)
        if io is not None:
            self.hbm_bytes += io
            self.bytes_accessed += io
            return out
        in_storages = {t.untyped_storage()._cdata for t in ins}
        mutable = func._schema.is_mutable
        written = sum(_nbytes(t) for t in outs
                      if mutable or t.untyped_storage()._cdata
                      not in in_storages)
        self.hbm_bytes += 2 * written
        self.bytes_accessed += written + sum(_nbytes(t) for t in ins)
        return out

    def _collective(self, name, args, outs) -> None:
        if name not in COLLECTIVES:
            raise NotImplementedError(f"collective {name} is not accounted")
        op, factor = COLLECTIVES[name]
        group = dist.distributed_c10d._resolve_process_group(
            args[-1]).size()
        self.groups.add(group)
        traffic = sum(_nbytes(t) for t in outs) * (
            group if factor is None else factor)
        self.per_op[op] = self.per_op.get(op, 0.0) + traffic
        self.counts[op] = self.counts.get(op, 0) + 1
        self.coll_bytes += traffic


# ---------------------------------------------------------------------------
# building the cell's tensors
# ---------------------------------------------------------------------------


def _fake_dtensor(shape, dtype, axes, mesh, rules, requires_grad=False):
    """A DTensor of global ``shape`` laid out by the logical ``axes``, its
    local shard a fresh fake tensor; on a mesh of one device a plain fake
    tensor (there is nothing to lay out)."""
    if math.prod(mesh.shape) == 1:
        return torch.empty(shape, dtype=dtype).requires_grad_(requires_grad)
    spec = spec_for(axes, shape, mesh, rules)
    placements = placements_for(spec, mesh)
    local = list(shape)
    for p, m in zip(placements, mesh.shape):
        if p.is_shard():
            local[p.dim] //= m
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    t = DTensor.from_local(torch.empty(local, dtype=dtype), mesh, placements,
                           shape=torch.Size(shape), stride=tuple(stride),
                           run_check=False)
    return t.requires_grad_(requires_grad)


def _tensors(tree, mesh, rules, axes_of):
    """Fake DTensors for a (nested) dict of ``TensorSpec``s."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tensors(v, mesh, rules, axes_of)
        else:
            out[k] = _fake_dtensor(v.shape, v.dtype, axes_of(k, v), mesh,
                                   rules)
    return out


def _distribute_model(cfg, mesh, rules, dtype, train):
    """A :class:`Model` whose parameters are fake DTensors laid out by
    ``param_specs`` (made on the fake device, no memory)."""
    with FakeTensorMode():  # the layout of modules, parameters replaced below
        model = Model(cfg, None, torch.device("cpu"))
    specs = param_specs(cfg)
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        dt = _fake_dtensor(tuple(p.shape), dtype, specs[name], mesh, rules)
        setattr(mod, attr, nn.Parameter(dt, requires_grad=train))
    return model


def _step_args(cfg, kind, specs, mesh, rules, param_dtype):
    """The step function's arguments, built as fake DTensors."""
    train = kind == "train"
    dtype = param_dtype or (torch.float32 if train else
                            getattr(torch, cfg.dtype))
    model = _distribute_model(cfg, mesh, rules, dtype, train)

    def batch_axes(_, v):
        return _BATCH_AXES[len(v.shape)]

    batch = _tensors(specs["batch"], mesh, rules, batch_axes)
    if train:
        from repro_torch.optim import adamw_init
        opt = adamw_init(dict(model.named_parameters()))
        return (model, opt, batch, 1)
    if kind in ("prefill", "encode"):
        return (model, batch)
    axes = cache_specs(cfg, dict(zip(mesh.mesh_dim_names,
                                     mesh.shape)).get("model", 1))
    cache = _tensors(specs["cache"], mesh, rules, lambda k, v: axes[k])
    pos = _fake_dtensor(specs["pos"].shape, specs["pos"].dtype, ("batch",),
                        mesh, rules)
    return (model, batch, cache, pos)


def trace_step(cfg: ModelConfig, kind: str, specs: Dict, mesh,
               rules: Dict, param_dtype: Optional[torch.dtype] = None
               ) -> Dict:
    """Run ``step_fn_for(cfg, kind)`` once on fake DTensors over ``mesh``
    and return one device's counts."""
    step = step_fn_for(cfg, kind)
    counter = DeviceCounter()
    with FakeTensorMode(allow_non_fake_inputs=False), \
            mesh_context(mesh, rules), kernel_dryrun.dry_run(), \
            counter.around_propagation(), counter:
        args = _step_args(cfg, kind, specs, mesh, rules, param_dtype)
        counter.reset()
        argument_bytes = counter.live
        t0 = time.perf_counter()
        out = step(*args)
        trace_s = time.perf_counter() - t0
        leaves = [t for t in tree_flatten(out)[0]
                  if isinstance(t, torch.Tensor)]
        local = [t.to_local() if isinstance(t, DTensor) else t
                 for t in leaves]
        output_bytes = sum({t.untyped_storage()._cdata:
                            t.untyped_storage().nbytes()
                            for t in local}.values())
        del out, leaves, local, args
    return dict(
        trace_s=trace_s, flops=float(counter.flops),
        hbm_bytes=float(counter.hbm_bytes),
        bytes_accessed=float(counter.bytes_accessed), n_ops=counter.n_ops,
        collective=dict(total_bytes=counter.coll_bytes,
                        per_op=dict(counter.per_op),
                        counts=dict(counter.counts),
                        group_sizes=sorted(counter.groups)),
        memory=dict(argument_bytes=argument_bytes, output_bytes=output_bytes,
                    temp_bytes=counter.peak - argument_bytes,
                    peak_bytes=counter.peak))


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def _mesh_name(mesh) -> str:
    if tuple(mesh.mesh_dim_names) == ("data", "model") \
            and tuple(mesh.shape) == (16, 16):
        return "pod16x16"
    if tuple(mesh.shape) == (2, 16, 16):
        return "pod2x16x16"
    return "mesh" + "x".join(str(n) for n in mesh.shape)


def run_cell(arch: str, shape, multi_pod: bool,
             out_dir: str = "experiments/dryrun_torch",
             cfg_override: Optional[ModelConfig] = None,
             tag: str = "", rules_patch: Optional[Dict] = None, *,
             mesh_shape: Optional[Sequence[int]] = None,
             param_dtype: Optional[torch.dtype] = None) -> Dict:
    """Dry-run one cell and write its record to ``out_dir/<cell>.json``.

    ``shape`` is a name of :data:`SHAPES` or a :class:`ShapeCell`;
    ``mesh_shape`` replaces the production mesh by a ("data", "model")
    mesh of that shape (``(1, 1)``: one card); ``param_dtype`` replaces the
    parameters' dtype (the reference's: float32 for train, ``cfg.dtype``
    for serving)."""
    base_cfg = cfg_override or get_config(arch)
    cell = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    ok, why = cell_supported(base_cfg, cell)
    with mesh_mod.fake_world():
        if mesh_shape is not None:
            mesh = mesh_mod.make_mesh(mesh_shape, ("data", "model"))
        else:
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        mesh_name = _mesh_name(mesh)
        cell_id = f"{arch}__{cell.name}__{mesh_name}" + (
            f"__{tag}" if tag else "")
        if not ok:
            rec = dict(cell=cell_id, arch=arch, shape=cell.name,
                       mesh=mesh_name, status="skipped", reason=why)
            _write(out_dir, cell_id, rec)
            print(f"SKIP  {cell_id}: {why}")
            return rec
        cfg = cfg_for_cell(base_cfg, cell)
        kind = step_kind(cfg, cell)
        rules = default_rules(mesh)
        if rules_patch:
            rules.update(rules_patch)
        counts = trace_step(cfg, kind, input_specs(cfg, cell), mesh, rules,
                            param_dtype)
        n_dev = math.prod(mesh.shape)
    rec = dict(
        cell=cell_id, arch=arch, shape=cell.name, mesh=mesh_name,
        status="ok", kind=kind, n_devices=n_dev,
        batch=cell.batch, seq=cell.seq,
        lower_s=round(counts["trace_s"], 2), compile_s=0.0,
        flops_per_device=counts["flops"],
        bytes_per_device=counts["bytes_accessed"],
        hbm_bytes_per_device=counts["hbm_bytes"],
        collective=counts["collective"], memory=counts["memory"],
        hlo_bytes=0, n_ops=counts["n_ops"],
        param_dtype=str(param_dtype).replace("torch.", "")
        if param_dtype else None,
    )
    _write(out_dir, cell_id, rec)
    mem, coll = rec["memory"], rec["collective"]
    print(f"OK    {cell_id}: trace {rec['lower_s']:.1f}s flops/dev "
          f"{rec['flops_per_device']:.3e} peak/dev "
          f"{mem['peak_bytes'] / 2**30:.2f}GiB coll/dev "
          f"{coll['total_bytes'] / 2**30:.3f}GiB")
    return rec


def _write(out_dir: str, cell_id: str, rec: Dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch == "all") else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape == "all") \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    run_cell(arch, shape, multi, out_dir=args.out)
                except Exception as e:  # a failing cell is a bug: surface it
                    failures.append((arch, shape, multi, repr(e)))
                    print(f"FAIL  {arch}__{shape}__"
                          f"{'multi' if multi else 'single'}: {e!r}")
                    traceback.print_exc(file=sys.stdout)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         + "; ".join(f"{a}x{s}" for a, s, _, _ in failures))
    print("DRY-RUN COMPLETE")


if __name__ == "__main__":
    main()
