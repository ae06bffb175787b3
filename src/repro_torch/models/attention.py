"""GQA attention for decode, and the KV-cache updates.

Counterpart of the reference's ``models/attention.py``.  Prefill attention
is :func:`repro_torch.kernels.flash_attention.ops.flash_attention`, the
counterpart of the reference's ``chunked_gqa_attention`` (with
``q_offset`` 0, as prefill calls it): the hand-written kernel on CUDA, its
plain float32 version on the CPU.  There is no ``attn_impl`` switch.
Single-token decode is plain PyTorch, as in the reference, with the same
finite ``-1e30`` mask.  The reference's arrays are immutable; here
:func:`append_kv` and :func:`update_positions` write into the cache in
place, so a decode step moves one token's K/V instead of copying the cache.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["decode_gqa_attention", "append_kv", "update_positions"]

_NEG_INF = -1e30


def decode_gqa_attention(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, kv_positions: torch.Tensor,
                         pos: torch.Tensor, *,
                         window: Optional[int] = None) -> torch.Tensor:
    """One query token against a (possibly ring) KV cache.

    q (B,1,H,hd); cache_k/v (B,cap,K,hd); kv_positions (B,cap), -1 for an
    empty slot; pos (B,) the current position.  Returns (B,1,H,hd).
    """
    B, _, H, hd = q.shape
    K = cache_k.shape[2]
    G = H // K
    # scaled in q's dtype, the scale rounded to it first, as the reference
    scale = torch.full((), 1.0 / (hd ** 0.5), dtype=q.dtype, device=q.device)
    qg = (q * scale).reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), cache_k.float())
    mask = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        mask = mask & (kv_positions > pos[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype), cache_v)
    return out.reshape(B, 1, H, hd)


def append_kv(cache_k: torch.Tensor, cache_v: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor,
              pos: torch.Tensor) -> None:
    """Write one token's K/V at ``pos % capacity`` (ring), in place."""
    slot = (pos % cache_k.shape[1]).long()
    b_idx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[b_idx, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[b_idx, slot] = v_new[:, 0].to(cache_v.dtype)


def update_positions(positions: torch.Tensor, pos: torch.Tensor) -> None:
    """Record the appended token's absolute position (once per step), in
    place."""
    slot = (pos % positions.shape[1]).long()
    b_idx = torch.arange(positions.shape[0], device=positions.device)
    positions[b_idx, slot] = pos.to(positions.dtype)
