"""Logical-axis partitioning context (MaxText-style), over DTensor.

Counterpart of the reference's ``launch/partitioning.py``.  Model code
annotates tensors with *logical* axis names; the launcher installs a mesh
and rules mapping logical names to mesh axes.  Outside any context (unit
tests, one-card runs) every annotation is a no-op.

Rules drop mappings that do not divide evenly (e.g. 8 KV heads on a
16-wide ``model`` axis fall back to replicated) and never use a mesh axis
twice, which keeps one config portable across meshes.  :func:`spec_for`
returns the reference's spec tuples (per dimension a mesh axis name, a
tuple of names, or None); :func:`placements_for` turns one into DTensor
placements, ``Shard(d)`` on each mesh dimension that tensor dimension
``d`` maps to and ``Replicate()`` elsewhere.  A sharding is the pair
``(mesh, placements)``.

The reference's ``auto_axis_types`` (JAX's ``AxisType.Auto`` keyword for
``jax.make_mesh``) has no PyTorch analogue: a ``DeviceMesh`` has no axis
types, and DTensor redistributes only where told to.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.obs import trace as _obs

__all__ = [
    "default_rules", "mesh_context", "logical_constraint", "spec_for",
    "placements_for", "sharding_for", "tree_shardings", "current_mesh",
    "current_batch_shards", "current_batch_axes", "gathered",
    "count_casts", "shard_index", "CAST_BYTES",
]

# The tracer's count of bytes written by casts of parameters at their use.
CAST_BYTES = "weights.cast_bytes"

AxisName = Union[str, Tuple[str, ...], None]

_state = threading.local()


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _size(mesh, name: str) -> int:
    return mesh.shape[_names(mesh).index(name)]


def default_rules(mesh) -> Dict[str, AxisName]:
    """Logical-axis → mesh-axis rules for the production meshes."""
    axes = _names(mesh)
    batch: AxisName = ("pod", "data") if "pod" in axes else ("data",)
    return {
        "batch": batch,
        "vocab": "model",
        "embed_fsdp": "data",    # FSDP within a pod; never across pods
        "heads": "model",        # tensor parallel
        "ff": "model",
        "expert": "model",       # expert parallel
        "ssm_inner": "model",
        "q_heads": "model",
        "kv_heads": "model",
        "kv_seq": "model",       # flash-decoding style cache sharding
        "seq_sp": "model",       # sequence-parallel saved activations
        "layer": None,
        "seq": None,
    }


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[Dict[str, AxisName]] = None):
    """Install ``mesh`` and ``rules``; inside, a plain tensor that meets a
    DTensor counts as replicated (a position table, a scale)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules or default_rules(mesh))
    try:
        with implicit_replication():
            yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def current_batch_axes() -> Tuple[str, ...]:
    """Mesh axes the 'batch' logical axis maps to (empty w/o context)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return ()
    mesh, rules = ctx
    target = rules.get("batch")
    if target is None:
        return ()
    names = (target,) if isinstance(target, str) else tuple(target)
    return tuple(n for n in names if n in _names(mesh))


def current_batch_shards() -> int:
    """Number of shards the 'batch' logical axis maps to (1 w/o context)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return 1
    size = 1
    for n in current_batch_axes():
        size *= _size(ctx[0], n)
    return size


def _resolve(axis: Optional[str], dim: int, mesh,
             rules: Dict[str, AxisName], used: set) -> AxisName:
    if axis is None:
        return None
    target = rules.get(axis)
    if target is None:
        return None
    names = (target,) if isinstance(target, str) else tuple(target)
    names = tuple(n for n in names if n in _names(mesh) and n not in used)
    if not names:
        return None
    size = 1
    for n in names:
        size *= _size(mesh, n)
    if dim % size != 0:
        return None  # non-divisible -> replicate (portable configs)
    used.update(names)
    return names if len(names) > 1 else names[0]


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: Dict[str, AxisName]) -> Tuple[AxisName, ...]:
    """The reference's ``PartitionSpec`` entries for a tensor of ``shape``
    whose dimensions carry the logical ``axes``."""
    used: set = set()
    return tuple(_resolve(a, d, mesh, rules, used)
                 for a, d in zip(axes, shape))


def placements_for(spec: Sequence[AxisName], mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension of more than one device that tensor dimension ``d``
    maps to (a tuple of names shards major to minor, as JAX's),
    ``Replicate()`` on the others.  A mesh dimension of one device splits
    nothing, and DTensor refuses to reshape a tensor dimension sharded even
    over one device, so there the placement is ``Replicate()``: on a
    ``(1, 1)`` mesh every tensor is replicated."""
    out: List = [Replicate()] * len(_names(mesh))
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            i = _names(mesh).index(name)
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


def logical_constraint(x, *axes: Optional[str]):
    """Redistribute a DTensor to the placements of the logical ``axes``
    (the reference's ``with_sharding_constraint``), its gradient too, as
    JAX constrains the cotangent; a no-op outside a mesh context and for a
    plain tensor."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    placements = placements_for(spec_for(axes, x.shape, mesh, rules), mesh)
    if not x.requires_grad:
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(mesh, placements)
    return _Constrain.apply(x, mesh, tuple(placements))


class _Constrain(torch.autograd.Function):
    """``x.redistribute(mesh, placements)`` whose backward lays the
    gradient out by ``placements`` before returning it to x's own
    layout (a partial sum's gradient is replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        ctx.src = tuple(Replicate() if p.is_partial() else p
                        for p in x.placements)
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(ctx.mesh, ctx.placements)
        return g.redistribute(ctx.mesh, ctx.src), None, None


def count_casts(dtype, *ws) -> None:
    """Add to the tracer's :data:`CAST_BYTES` what casting each parameter
    of ``ws`` to ``dtype`` writes (``numel × itemsize``, this device's
    shard of a DTensor), for those not in ``dtype`` already: shapes only,
    no device read.  Callers guard it with ``if _obs.enabled``."""
    n = 0
    for w in ws:
        if w.dtype != dtype:
            n += (w.to_local() if isinstance(w, DTensor) else w).numel()
    if n:
        _obs.count(CAST_BYTES, n * dtype.itemsize)


def gathered(w, dtype):
    """A parameter at its use: ``w.to(dtype)``; a DTensor is also gathered
    over the mesh axes that hold its FSDP shards (the rules' "embed_fsdp"
    target, ZeRO-3 style: an all-gather at use, whose backward
    reduce-scatters the gradient), keeping its tensor-parallel split.
    Under tracing the cast counts in :data:`CAST_BYTES`."""
    if _obs.enabled:
        count_casts(dtype, w)
    w = w.to(dtype)
    ctx = getattr(_state, "ctx", None)
    if ctx is None or not isinstance(w, DTensor):
        return w
    mesh, rules = ctx
    target = rules.get("embed_fsdp")
    names = () if target is None else (
        (target,) if isinstance(target, str) else tuple(target))
    pl = [Replicate() if n in names and p.is_shard() else p
          for n, p in zip(_names(mesh), w.placements)]
    return w if pl == list(w.placements) else w.redistribute(mesh, pl)


def shard_index(mesh, dims: Sequence[int]) -> int:
    """This device's index among the shards that the mesh dimensions
    ``dims`` (in mesh order) cut a tensor dimension into, major to minor
    as DTensor shards: its slice of a size-``n`` dimension starts at
    ``shard_index * n_local``."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def sharding_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
                 rules: Optional[Dict[str, AxisName]] = None):
    """``(mesh, placements)`` of a tensor of ``shape`` with logical
    ``axes``."""
    rules = rules or default_rules(mesh)
    return mesh, placements_for(spec_for(axes, shape, mesh, rules), mesh)


def tree_shardings(axes_tree: Dict, shapes_tree: Dict, mesh,
                   rules: Optional[Dict[str, AxisName]] = None) -> Dict:
    """``{name: (mesh, placements)}`` from ``{name: axes}`` and ``{name:
    shape}`` (flat or nested dicts of the same keys)."""
    rules = rules or default_rules(mesh)
    out = {}
    for k, axes in axes_tree.items():
        shape = shapes_tree[k]
        if isinstance(axes, dict):
            out[k] = tree_shardings(axes, shape, mesh, rules)
        else:
            out[k] = sharding_for(axes, shape, mesh, rules)
    return out
