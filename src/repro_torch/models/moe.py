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
stream on its own, with a per-shard capacity, as the reference's
shard-local dispatch does without a mesh.  Its expert-parallel form across
cards (the reference's ``shard_map`` branch) waits for ROADMAP A11d.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Routing", "route", "moe_capacity", "moe_block",
           "moe_block_local"]


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


def _moe(x, router_w, w_gate, w_up, w_down, topk, capacity_factor,
         n_shards):
    B, S, d = x.shape
    E = router_w.shape[1]
    T = B * S
    Tl = T // n_shards
    C = moe_capacity(Tl, E, topk, capacity_factor)
    xs = x.reshape(n_shards, Tl, d)
    r = route(xs, router_w, topk, C)
    dev = x.device
    s_idx = torch.arange(n_shards, device=dev)[:, None]

    # ---- dispatch: gather each sorted entry's token, one scatter into
    # each shard's (E·C + 1) rows, the last the drop row
    rows = (s_idx * Tl + r.order // topk).reshape(-1)
    gathered = x.reshape(T, d)[rows]                        # (T·k, d)
    stride = E * C + 1
    flat_slot = (s_idx * stride + r.slot).reshape(-1)
    buf = x.new_zeros((n_shards * stride, d)).index_put(
        (flat_slot,), gathered)
    buf = buf.reshape(n_shards, stride, d)[:, :E * C]
    # (E, s·C, d): one batch of rows per expert
    buf = buf.reshape(n_shards, E, C, d).transpose(0, 1).reshape(
        E, n_shards * C, d)

    # ---- expert products (active work only), in the compute dtype
    dtype = x.dtype
    g = torch.bmm(buf, w_gate.to(dtype))
    u = torch.bmm(buf, w_up.to(dtype))
    out = torch.bmm(F.silu(g) * u, w_down.to(dtype))        # (E, s·C, d)
    out = out.reshape(E, n_shards, C, d).transpose(0, 1).reshape(
        n_shards * E * C, d)

    # ---- combine: each flat entry t·k + j reads its own row back (the
    # sort's permutation inverted), then the k contributions of a token
    # are summed; no scatter-add, no atomics
    slot_u = torch.empty_like(r.slot).scatter_(1, r.order, r.slot)
    keep_u = torch.empty_like(r.keep).scatter_(1, r.order, r.keep)
    pick = (s_idx * (E * C) + torch.clamp(slot_u, max=E * C - 1)).reshape(-1)
    w = (r.gate.reshape(n_shards, Tl * topk) * keep_u).to(dtype)
    contrib = out[pick] * w.reshape(-1, 1)                  # (T·k, d)
    y = contrib.reshape(T, topk, d).sum(dim=1)

    # Switch-style load-balance aux loss, in float32; its gradient flows
    # through the probabilities (``me``), the counts carry none
    me = r.probs.mean(dim=(0, 1))
    ce = r.counts.sum(0).float() / (T * topk)
    aux = dict(moe_aux_loss=E * torch.sum(me * ce),
               moe_dropped_frac=1.0 - r.keep.float().sum() / (T * topk),
               moe_frac_tokens=ce.mean())
    return y.reshape(B, S, d), aux


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
                    capacity_factor: float = 1.25, n_shards: int = 0,
                    mesh=None) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """Shard-local dispatch: each of ``n_shards`` slices of the ``B·S``
    tokens is routed on its own with a per-shard capacity (``n_shards <=
    0`` means 1, one card's batch; a count that does not divide the tokens
    falls back to 1, as the reference).  The expert-parallel exchange
    across the cards of a ``mesh`` waits for ROADMAP A11d."""
    n_shards = max(n_shards, 1)
    if (x.shape[0] * x.shape[1]) % n_shards:
        n_shards = 1
    if mesh is not None and n_shards > 1:
        raise NotImplementedError(
            "moe_block_local across a device mesh (the reference's "
            "shard_map dispatch) waits for ROADMAP A11d")
    return _moe(x, router_w, w_gate, w_up, w_down, topk, capacity_factor,
                n_shards)
