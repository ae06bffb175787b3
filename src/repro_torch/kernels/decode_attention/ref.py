"""Plain PyTorch version of the decode-attention kernel.

The reference's ``models/attention.py::decode_gqa_attention`` in PyTorch:
one query token against a (possibly ring) KV cache, an einsum, the finite
``-1e30`` mask, a float32 softmax and a second einsum.  q is scaled in its
own dtype by the scale rounded to it; the q.k products of the operands are
summed in float32; p is rounded to q's dtype before it meets V.  Used for
CPU tensors and as the kernel's oracle on the card; :func:`scores` is also
the per-device score pass of a sequence-sharded cache
(``models.attention._sharded_decode``).  :func:`write` is the one write
of a token's rows into a cache or a device's shard of it
(``models.attention.append_kv`` and ``update_positions``); the kernel
takes on its whole-cache case for K and V.  :func:`case` and
:data:`CHECKED` are the seeded inputs and shapes on which the kernel is
held to this version on the card (the ``cuda`` tests and
``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["NEG_INF", "CHECKED", "default_scale", "decode_attention",
           "scores", "write", "case"]

NEG_INF = -1e30


def default_scale(hd: int) -> float:
    """The softmax scale when none is given, ``1/sqrt(hd)``."""
    return 1.0 / (hd ** 0.5)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, kv_positions: torch.Tensor,
                     pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,H,hd); cache_k/v (B,cap,K,hd); kv_positions (B,cap), -1 for
    an empty slot; pos (B,) the current position; ``scale`` the softmax
    scale (default ``1/sqrt(hd)``).  Returns (B,1,H,hd)."""
    B, _, H, hd = q.shape
    s = scores(q, cache_k, kv_positions, pos, window, scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype), cache_v)
    return out.reshape(B, 1, H, hd)


def scores(q, cache_k, kv_positions, pos, window, scale=None):
    """Masked float32 scores (B, K, G, cap) of one query token."""
    B, _, H, hd = q.shape
    K = cache_k.shape[2]
    # scaled in q's dtype, the scale rounded to it first, as the reference
    sc = torch.full((), default_scale(hd) if scale is None else scale,
                    dtype=q.dtype, device=q.device)
    qg = (q * sc).reshape(B, K, H // K, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), cache_k.float())
    mask = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        mask = mask & (kv_positions > pos[:, None] - window)
    return torch.where(mask[:, None, None, :], s, NEG_INF)


def write(cap: int, offset: int, caches, news, pos) -> None:
    """``cache[b, pos[b] % cap - offset] = new[b]`` for each cache, where
    that slot lies in this cache's ``offset .. offset + len`` (all of them
    when ``offset`` is 0 and the cache is whole)."""
    slot = (pos % cap).long() - offset
    n = caches[0].shape[1]
    b_idx = torch.arange(caches[0].shape[0], device=caches[0].device)
    if offset == 0 and n == cap:
        for c, t in zip(caches, news):
            c[b_idx, slot] = t.to(c.dtype)
        return
    mine = (slot >= 0) & (slot < n)
    slot = torch.clamp(slot, 0, n - 1)
    for c, t in zip(caches, news):
        keep = mine.reshape((-1,) + (1,) * (t.dim() - 1))
        c[b_idx, slot] = torch.where(keep, t.to(c.dtype), c[b_idx, slot])


# (B, cap, H, K, hd, kind, window) of the kernel's checks on the card
CHECKED = (
    (32, 1792, 16, 16, 128, "fill", None),   # the decode cell's caps
    (32, 960, 16, 16, 128, "fill", None),
    (8, 781, 16, 16, 128, "fill", None),     # the prefill cell's
    (8, 3853, 16, 16, 128, "full", None),
    (2, 1000, 64, 8, 128, "fill", None),     # G = 8 (qwen2-vl, llama3)
    (2, 1000, 48, 8, 128, "fill", None),     # G = 6 (dbrx)
    (1, 600, 96, 8, 128, "fill", None),      # G = 12: two head groups
    (3, 700, 16, 4, 128, "ring", 300),       # a ring cache, wrapped
    (1, 333, 32, 32, 80, "fill", None),      # cap off the tile; hd 80
    (4, 517, 32, 8, 160, "none", None),      # no valid slot; 320 B bf16 rows
)


def case(seed, B, cap, H, K, hd, kind="fill", dtype=torch.float32,
         device="cpu"):
    """Seeded ``(q, cache_k, cache_v, kv_positions, pos)`` in the cache
    layout.  ``kind``: "full" (every slot holds a position up to
    pos = cap - 1), "fill" (each row's first n slots, n drawn per row, the
    rest empty, -1: a prefill's cache with room to decode), "ring" (each
    row's last cap positions of a longer sequence, slot = position % cap,
    so the positions wrap) or "none" (row 0 has no valid slot, the others
    as "fill")."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, dtype) for shape in (
            (B, 1, H, hd), (B, cap, K, hd), (B, cap, K, hd)))
    slots = np.arange(cap)[None]
    if kind == "full":
        kvpos = np.broadcast_to(slots, (B, cap))
        pos = np.full(B, cap - 1)
    elif kind == "ring":
        pos = rng.integers(cap, 3 * cap, B)
        kvpos = pos[:, None] - (pos[:, None] - slots) % cap
    else:
        n = rng.integers(1, cap + 1, B)
        kvpos = np.where(slots < n[:, None], slots, -1)
        pos = n - 1
        if kind == "none":
            kvpos[0] = -1
    return q, k, v, *(torch.from_numpy(np.ascontiguousarray(
        a, np.int32)).to(device) for a in (kvpos, pos))
