"""Top-k Mixture-of-Experts with sort-based token dispatch.

Counterpart of the reference's ``models/moe.py``.  Dispatch is a stable
sort of the flat expert ids, gathers and one scatter into a
capacity-bounded per-expert buffer ``(E, C, d)`` (plus one drop row); the
three expert products are ``torch.bmm`` in the compute dtype, so the work
is the *active* parameters' (top-k experts per token), not the one-hot
dispatch einsum's ``T·E·C·d``.

Routing (:func:`route`) runs in float32 on the router product's float32
accumulation, as the reference's ``preferred_element_type=float32``, so in
float32 the port routes every token as the reference does.

The combine differs from the reference's in one respect: the reference
scatter-adds each token's k contributions into ``y`` (``.at[tok_of].add``),
which on CUDA would be ``index_add_``'s atomics, whose bf16 sums change
from run to run; under ``remat="full"`` the backward recomputes the block,
and a different ``h`` there could route a token elsewhere.  Here each flat
entry ``t·k + j`` reads back its own expert row (the sort's permutation
inverted), the ``(T, k, d)`` contributions are summed over k, and two calls
are bitwise equal.  It differs from the reference's bf16 scatter-add by
rounding alone.  The gathers are advanced indexing, whose backward on CUDA
accumulates through a sort, not atomics.

:func:`moe_block_local` routes each of ``n_shards`` slices of the token
stream on its own, with a per-shard capacity (``n_shards <= 0``: one per
batch shard of the mesh context, ``launch.partitioning.
current_batch_shards()``).  Given DTensors (a mesh), both blocks take the
expert-parallel form of the reference's ``_moe_shardmap``: dispatch and
combine run on each data shard's tokens through ``local_map`` (replicated
over ``model``), the expert products run on the ``expert``-sharded weights
(each ``model`` device its own experts), and each device's combine of its
experts' rows is a partial sum that the ``y`` constraint reduces over
``model``.  The combine keeps the design above: no scatter-add.

Under tracing (:mod:`repro_torch.obs.trace`) the one-device block records
four sibling spans, ``moe.route``, ``moe.dispatch`` (the gather and the
buffer scatter), ``moe.experts`` (the weight casts and the three ``bmm``)
and ``moe.combine``, and counts the router's and the experts' casts to the
compute dtype in ``weights.cast_bytes``.  The expert-parallel form records
no span.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.partitioning import (count_casts,
                                             current_batch_axes,
                                             current_batch_shards,
                                             gathered, logical_constraint,
                                             shard_index)
from repro_torch.obs import trace as _obs

__all__ = ["Routing", "route", "moe_capacity", "moe_block",
           "moe_block_local"]

_NOSPAN = contextlib.nullcontext()      # a phase's context while untraced


class Routing(NamedTuple):
    """One routing of ``s`` shards of ``Tl`` tokens each (``s = 1`` for
    :func:`moe_block`); flat entries are ``t·k + j`` for token t's j-th
    expert, and "sorted" means in the stable order of their expert ids."""
    probs: torch.Tensor       # (s, Tl, E) float32 router softmax
    expert_idx: torch.Tensor  # (s, Tl, k) int64, in topk's order
    gate: torch.Tensor        # (s, Tl, k) float32, renormalised over k
    order: torch.Tensor       # (s, Tl·k) flat entry at each sorted place
    slot: torch.Tensor        # (s, Tl·k) sorted: buffer row, E·C if dropped
    keep: torch.Tensor        # (s, Tl·k) sorted: bool, within capacity
    counts: torch.Tensor      # (s, E) int64 entries routed to each expert


def moe_capacity(num_tokens: int, n_experts: int, topk: int,
                 capacity_factor: float) -> int:
    """Slots per expert, rounded up to a multiple of 8 (at least 8)."""
    c = int(num_tokens * topk / n_experts * capacity_factor)
    return max(-(-c // 8) * 8, 8)


def route(xs: torch.Tensor, router_w: torch.Tensor, topk: int,
          C: int) -> Routing:
    """Route the tokens ``xs`` (s, Tl, d) of each shard to ``topk`` experts
    of capacity ``C``.

    ``torch.topk``'s order among exactly equal probabilities is
    unspecified, unlike ``lax.top_k``'s.  That can only permute the gates
    inside one token: a token picks an expert once, and the ranks within an
    expert follow the stable sort over ``t·k + j``, that is token order.
    Nothing here relies on the order within a token.
    """
    s, Tl, _ = xs.shape
    E = router_w.shape[1]
    if _obs.enabled:
        count_casts(xs.dtype, router_w)
    # bf16 operands, float32 accumulation: the products of two bf16 values
    # are exact in float32
    logits = xs.float() @ router_w.to(xs.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, topk, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(s, Tl * topk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((s, E), dtype=torch.int64, device=xs.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(Tl * topk, device=xs.device)[None] \
        - torch.gather(starts, 1, sorted_e)
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + torch.clamp(rank, max=C - 1),
                       E * C)
    return Routing(probs, expert_idx, gate, order, slot, keep, counts)


def _dispatch(xs, r, topk, C):
    """Dispatch ``xs`` (s, Tl, d) by its routing ``r``: ``buf (s, E, C,
    d)``, one scatter of each sorted entry's token into each shard's
    (E·C + 1) rows, the last the drop row."""
    n_shards, Tl, d = xs.shape
    E = r.counts.shape[1]
    s_idx = torch.arange(n_shards, device=xs.device)[:, None]
    rows = (s_idx * Tl + r.order // topk).reshape(-1)
    gathered = xs.reshape(n_shards * Tl, d)[rows]          # (s·Tl·k, d)
    stride = E * C + 1
    flat_slot = (s_idx * stride + r.slot).reshape(-1)
    buf = xs.new_zeros((n_shards * stride, d)).index_put(
        (flat_slot,), gathered)
    buf = buf.reshape(n_shards, stride, d)[:, :E * C]
    return buf.reshape(n_shards, E, C, d)


def _combine(out, r, topk, e0=0):
    """``y`` (s, Tl, d) from the expert outputs ``out`` (s, El, C, d) of
    experts ``e0 .. e0 + El``: each flat entry t·k + j reads its own row
    back (the sort's permutation inverted) and the k contributions of a
    token are summed; no scatter-add, no atomics.  Entries routed to other
    experts contribute zero (a partial sum, when ``El`` < E)."""
    n_shards, El, C, d = out.shape
    Tl = r.gate.shape[1]
    s_idx = torch.arange(n_shards, device=out.device)[:, None]
    slot_u = torch.empty_like(r.slot).scatter_(1, r.order, r.slot)
    keep_u = torch.empty_like(r.keep).scatter_(1, r.order, r.keep)
    local = slot_u - e0 * C
    mine = keep_u & (local >= 0) & (local < El * C)
    pick = (s_idx * (El * C)
            + torch.clamp(local, min=0, max=El * C - 1)).reshape(-1)
    w = (r.gate.reshape(n_shards, Tl * topk) * mine).to(out.dtype)
    contrib = out.reshape(n_shards * El * C, d)[pick] * w.reshape(-1, 1)
    return contrib.reshape(n_shards, Tl, topk, d).sum(dim=2)


def _aux(r, T, topk):
    """Switch-style load-balance aux loss, in float32; its gradient flows
    through the probabilities (``me``), the counts carry none."""
    E = r.probs.shape[-1]
    me = r.probs.mean(dim=(0, 1))
    ce = r.counts.sum(0).float() / (T * topk)
    return dict(moe_aux_loss=E * torch.sum(me * ce),
                moe_dropped_frac=1.0 - r.keep.float().sum() / (T * topk),
                moe_frac_tokens=ce.mean())


def _moe(x, router_w, w_gate, w_up, w_down, topk, capacity_factor,
         n_shards):
    B, S, d = x.shape
    E = router_w.shape[1]
    T = B * S
    Tl = T // n_shards
    C = moe_capacity(Tl, E, topk, capacity_factor)
    if isinstance(x, DTensor):  # a mesh: the reference's sharding sites
        return _moe_sharded(x, router_w, w_gate, w_up, w_down, topk, C,
                            n_shards)
    xs = x.reshape(n_shards, Tl, d)
    with _obs.span("moe.route") if _obs.enabled else _NOSPAN:
        r = route(xs, router_w, topk, C)
    with _obs.span("moe.dispatch") if _obs.enabled else _NOSPAN:
        buf = _dispatch(xs, r, topk, C)
    with _obs.span("moe.experts") if _obs.enabled else _NOSPAN:
        out = _experts(buf, w_gate, w_up, w_down)
    with _obs.span("moe.combine") if _obs.enabled else _NOSPAN:
        y = _combine(out, r, topk)
    return y.reshape(B, S, d), _aux(r, T, topk)


def _experts(buf, w_gate, w_up, w_down):
    """The expert products of ``buf`` (s, E, C, d), active work only, in
    its dtype: ``out`` (s, E, C, d)."""
    n_shards, E, C, d = buf.shape
    dtype = buf.dtype
    if _obs.enabled:
        count_casts(dtype, w_gate, w_up, w_down)
    # (E, s·C, d): one batch of rows per expert
    buf = buf.transpose(0, 1).reshape(E, n_shards * C, d)
    g = torch.bmm(buf, w_gate.to(dtype))
    u = torch.bmm(buf, w_up.to(dtype))
    out = torch.bmm(F.silu(g) * u, w_down.to(dtype))        # (E, s·C, d)
    return out.reshape(E, n_shards, C, d).transpose(0, 1)


def _moe_sharded(x, router_w, w_gate, w_up, w_down, topk, C, n_shards):
    """The reference's ``_moe_shardmap`` on DTensors: dispatch and combine
    per data shard (``local_map``, replicated over ``model``), the expert
    products on the ``expert``-sharded weights, each ``model`` device's
    combine a partial sum that the ``y`` constraint reduces."""
    B, S, d = x.shape
    T = B * S
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    batch = current_batch_axes() or tuple(
        a for a in ("pod", "data") if a in names)
    batch_pl = [Shard(0) if n in batch and n_shards > 1 else Replicate()
                for n in names]
    repl = [Replicate()] * len(names)
    xs = logical_constraint(x.reshape(n_shards, T // n_shards, d),
                            "batch", None, None)

    def dispatch(xl, rw):
        r = route(xl, rw, topk, C)
        return (_dispatch(xl, r, topk, C), *r)

    # the router is whole on every data shard, each of which routes its
    # own tokens: its gradient is a partial sum over the batch axes
    router_grad = [Partial() if p == Shard(0) else p for p in batch_pl]
    disp = local_map(dispatch, out_placements=(batch_pl,) * 8,
                     in_placements=(batch_pl, repl),
                     in_grad_placements=(batch_pl, router_grad),
                     device_mesh=mesh, redistribute_inputs=True)
    buf, *fields = disp(xs, router_w)
    r = Routing(*fields)
    buf = logical_constraint(buf, "batch", None, None, None)

    dtype = x.dtype
    g = torch.einsum("secd,edf->secf", buf, gathered(w_gate, dtype))
    u = torch.einsum("secd,edf->secf", buf, gathered(w_up, dtype))
    out = torch.einsum("secf,efd->secd", F.silu(g) * u,
                       gathered(w_down, dtype))
    out = logical_constraint(out, "batch", "expert", None, None)

    # each device combines the rows of its own experts: a partial sum over
    # the mesh axes that split the experts
    expert_dims = [i for i, p in enumerate(out.placements) if p == Shard(1)]
    out_pl = [Shard(1) if i in expert_dims else p
              for i, p in enumerate(batch_pl)]
    y_pl = [Partial() if i in expert_dims else p
            for i, p in enumerate(batch_pl)]

    def combine(ol, *rl):
        e0 = shard_index(mesh, expert_dims) * ol.shape[1]
        return _combine(ol, Routing(*rl), topk, e0)

    # the gates are whole on every expert device, each of which reads
    # those of its own experts: their gradients are partial sums there
    y = local_map(combine, out_placements=y_pl,
                  in_placements=(out_pl,) + (batch_pl,) * 7,
                  in_grad_placements=(out_pl,) + (y_pl,) * 7,
                  device_mesh=mesh, redistribute_inputs=True)(out, *r)
    y = logical_constraint(y, "batch", None, None)
    return y.reshape(B, S, d), _aux(r, T, topk)


def moe_block(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor, *, topk: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d); router_w (d, E); w_gate / w_up (E, d, ff); w_down
    (E, ff, d).  Returns ``(y (B, S, d), aux)`` with the aux terms
    ``moe_aux_loss``, ``moe_dropped_frac`` and ``moe_frac_tokens`` (0-d
    float32).  One routing over all ``B·S`` tokens, padding included."""
    return _moe(x, router_w, w_gate, w_up, w_down, topk, capacity_factor, 1)


def moe_block_local(x: torch.Tensor, router_w: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, *, topk: int,
                    capacity_factor: float = 1.25, n_shards: int = 0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shard-local dispatch: each of ``n_shards`` slices of the ``B·S``
    tokens is routed on its own with a per-shard capacity (``n_shards <=
    0`` means one per batch shard of the mesh context, 1 outside one; a
    count that does not divide the tokens falls back to 1, as the
    reference).  Given DTensors, the expert-parallel form (module doc)."""
    if n_shards <= 0:
        n_shards = current_batch_shards()
    if (x.shape[0] * x.shape[1]) % n_shards:
        n_shards = 1
    return _moe(x, router_w, w_gate, w_up, w_down, topk, capacity_factor,
                n_shards)
