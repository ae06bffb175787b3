"""GQA attention for decode, and the KV-cache updates.

Counterpart of the reference's ``models/attention.py``.  Prefill attention
is :func:`repro_torch.kernels.flash_attention.ops.flash_attention`, the
counterpart of the reference's ``chunked_gqa_attention`` (with
``q_offset`` 0, as prefill calls it): the hand-written kernel on CUDA, its
plain float32 version on the CPU.  Single-token decode is
:func:`repro_torch.kernels.decode_attention.ops.decode_attention`: on CUDA
a hand-written kernel that reads the cache once, in place; on the CPU the
reference's einsum-softmax-einsum with its finite ``-1e30`` mask
(``kernels/decode_attention/ref.py``).  There is no ``attn_impl`` switch.
The reference's arrays are immutable; here :func:`append_kv` and
:func:`update_positions` write into the cache in place, so a decode step
moves one token's K/V instead of copying the cache.  On DTensors (a mesh)
each device works on its own shard (``local_map``): its batch rows, its KV
heads and, for a sequence-sharded cache (flash-decoding style), the slots
it holds; decode attention over such a cache combines the devices' partial
softmaxes (an all-reduce of the row maximum, then of the rescaled sums),
in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import (scores as _scores,
                                                      write as _write)
from repro_torch.launch.partitioning import shard_index

__all__ = ["decode_gqa_attention", "append_kv", "update_positions"]


def decode_gqa_attention(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, kv_positions: torch.Tensor,
                         pos: torch.Tensor, *, window: Optional[int] = None,
                         k_new: Optional[torch.Tensor] = None,
                         v_new: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """One query token against a (possibly ring) KV cache.

    q (B,1,H,hd); cache_k/v (B,cap,K,hd); kv_positions (B,cap), -1 for an
    empty slot; pos (B,) the current position.  Returns (B,1,H,hd).  With
    ``k_new`` / ``v_new`` (B,1,K,hd), this token's K/V are first written
    at ``pos % capacity`` (:func:`append_kv`; on plain tensors inside the
    decode-attention call).  ``scale``: the softmax scale (default
    ``1/sqrt(hd)``).
    """
    if isinstance(cache_k, DTensor):
        if k_new is not None:
            append_kv(cache_k, cache_v, k_new, v_new, pos)
        return _sharded_decode(q, cache_k, cache_v, kv_positions, pos,
                               window, scale)
    return decode_ops.decode_attention(q, cache_k, cache_v, kv_positions, pos,
                                       window=window, k_new=k_new,
                                       v_new=v_new, scale=scale)


def _sharded_decode(q, cache_k, cache_v, kv_positions, pos, window, scale):
    """:func:`decode_gqa_attention` of DTensors, each device on its batch
    rows and KV heads (q follows the cache's head split).  Over a
    sequence-sharded cache each device attends to its slots and the
    partial softmaxes combine: the row maximum all-reduced by max, the
    rescaled value sums and denominators by sum."""
    mesh = cache_k.device_mesh
    cpl = tuple(cache_k.placements)
    seq_dims = [i for i, p in enumerate(cpl) if p == Shard(1)]
    q_pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                 for p in cpl)
    row_pl = tuple(p if p == Shard(0) else Replicate() for p in cpl)
    kvpos_pl = tuple(p if p in (Shard(0), Shard(1)) else Replicate()
                     for p in cpl)
    args = (q, cache_k, cache_v, kv_positions, pos)
    in_pl = (q_pl, cpl, cpl, kvpos_pl, row_pl)
    if not seq_dims:
        return local_map(
            lambda *a: decode_gqa_attention(*a, window=window, scale=scale),
            out_placements=list(q_pl), in_placements=in_pl, device_mesh=mesh,
            redistribute_inputs=True)(*args)
    # (B, K, G, ...) layouts: heads at dim 1
    s_pl = tuple(Shard(1) if p == Shard(2) else
                 Shard(3) if p == Shard(1) else p for p in cpl)
    red_pl = [Shard(1) if p == Shard(2) else p for p in cpl]
    m_pl = tuple(Partial("max") if i in seq_dims else p
                 for i, p in enumerate(red_pl))
    sum_pl = tuple(Partial() if i in seq_dims else p
                   for i, p in enumerate(red_pl))

    def scores(ql, kl, kvl, pl):
        s = _scores(ql, kl, kvl, pl, window, scale)
        return s, torch.amax(s, dim=-1, keepdim=True)

    s, m = local_map(scores, out_placements=(s_pl, m_pl),
                     in_placements=(q_pl, cpl, kvpos_pl, row_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, cache_k, kv_positions, pos)
    whole = tuple(Replicate() if i in seq_dims else p
                  for i, p in enumerate(red_pl))
    m = m.redistribute(mesh, whole)

    def partial_sums(sl, ml, vl):
        p = torch.exp(sl - ml)
        o = torch.einsum("bkgs,bskh->bkgh", p, vl.float())
        return o, torch.sum(p, dim=-1, keepdim=True)

    o, den = local_map(partial_sums, out_placements=(sum_pl, sum_pl),
                       in_placements=(s_pl, whole, cpl),
                       device_mesh=mesh, redistribute_inputs=True)(
        s, m, cache_v)
    out = o.redistribute(mesh, whole) / den.redistribute(mesh, whole)
    B, _, H, hd = q.shape
    return out.to(q.dtype).reshape(B, 1, H, hd)


def append_kv(cache_k: torch.Tensor, cache_v: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor,
              pos: torch.Tensor) -> None:
    """Write one token's K/V at ``pos % capacity`` (ring), in place."""
    if isinstance(cache_k, DTensor):
        return _sharded_write(cache_k, (cache_k, cache_v), (k_new, v_new),
                              pos)
    _write(cache_k.shape[1], 0, (cache_k, cache_v),
           tuple(t[:, 0] for t in (k_new, v_new)), pos)


def update_positions(positions: torch.Tensor, pos: torch.Tensor) -> None:
    """Record the appended token's absolute position (once per step), in
    place."""
    if isinstance(positions, DTensor):
        return _sharded_write(positions, (positions,), (pos[:, None],), pos)
    _write(positions.shape[1], 0, (positions,), (pos,), pos)


def _sharded_write(like: DTensor, caches, news, pos) -> None:
    """:func:`_write` on each device's shard of DTensor caches laid out as
    ``like``: (B, cap, ...) sharded by batch, heads and (flash-decoding)
    the sequence."""
    mesh = like.device_mesh
    cap = like.shape[1]
    seq_dims = [i for i, p in enumerate(like.placements) if p == Shard(1)]
    new_pl = [Replicate() if p == Shard(1) else p for p in like.placements]
    pos_pl = [p if p == Shard(0) else Replicate() for p in like.placements]
    n = len(caches)

    def local(*ts):
        cs, ns, p = ts[:n], ts[n:2 * n], ts[-1]
        _write(cap, shard_index(mesh, seq_dims) * cs[0].shape[1], cs,
               tuple(t[:, 0] if t.dim() == c.dim() else t
                     for c, t in zip(cs, ns)), p)

    local_map(local, out_placements=None,
              in_placements=(tuple(like.placements),) * n
              + (tuple(new_pl),) * n + (tuple(pos_pl),),
              device_mesh=mesh, redistribute_inputs=True)(*caches, *news,
                                                          pos)
