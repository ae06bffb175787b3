"""Shared layers: RMSNorm, rotary embeddings (RoPE / M-RoPE), SwiGLU MLP,
embedding lookup.

Counterparts of the reference's ``models/layers.py``, with its dtype rules:
the norm and the rotation run in float32 and cast back; weights are cast
to the activations' dtype at each use.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.partitioning import gathered, shard_index

__all__ = ["rmsnorm", "swiglu", "rope_frequencies", "apply_rope",
           "apply_mrope", "embed_lookup"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32 with a cast back to the input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down(silu(x @ gate) * (x @ up))."""
    dtype = x.dtype
    g = x @ gathered(w_gate, dtype)
    u = x @ gathered(w_up, dtype)
    return (F.silu(g) * u) @ gathered(w_down, dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, hd); positions: (B, S) int."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * inv               # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the hd/2 rotary dimensions are split into
    (temporal, height, width) sections, each rotated by its own position id.

    x: (B, S, H, hd); positions3: (B, S, 3) int; sum(sections) == hd // 2.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to {hd // 2}")
    inv = rope_frequencies(hd, theta, x.device)
    # the section (0, 1 or 2) of each rotary dimension, made on the device
    # (no host copy, so a CUDA graph can capture it)
    dims = torch.arange(hd // 2, device=x.device)
    sec_id = (dims >= sections[0]).long() \
        + (dims >= sections[0] + sections[1]).long()
    pos = positions3.float()[..., sec_id]                  # (B, S, hd/2)
    ang = pos * inv
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather with a cast to the compute dtype; on a DTensor
    table, vocab-parallel (:func:`_sharded_lookup`)."""
    if isinstance(table, DTensor):
        return _sharded_lookup(gathered(table, table.dtype), tokens).to(dtype)
    return table[tokens.long()].to(dtype)


def _sharded_lookup(table, tokens):
    """Each device gathers the rows of its vocabulary slice (zeros for
    the other tokens) for its batch rows; the partial sums reduce over the
    mesh axes that split the vocabulary (Megatron's vocab-parallel
    embedding).  The table's gradient is a partial sum over the batch
    axes, each holding the rows its own tokens read."""
    mesh = table.device_mesh
    n = len(table.placements)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    tok_pl = [p if isinstance(tokens, DTensor) and p == Shard(0)
              else Replicate()
              for p in (tokens.placements if isinstance(tokens, DTensor)
                        else [Replicate()] * n)]
    table_pl = [Shard(0) if i in vocab else Replicate() for i in range(n)]
    table_grad = [Shard(0) if i in vocab else
                  Partial() if tok_pl[i] == Shard(0) else Replicate()
                  for i in range(n)]
    out_pl = [Partial() if i in vocab else tok_pl[i] for i in range(n)]

    def local(tl, tok):
        t = tok.long() - shard_index(mesh, vocab) * tl.shape[0]
        mine = (t >= 0) & (t < tl.shape[0])
        rows = tl[torch.clamp(t, 0, tl.shape[0] - 1)]
        return rows * mine[..., None].to(rows.dtype)

    return local_map(local, out_placements=out_pl,
                     in_placements=(table_pl, tok_pl),
                     in_grad_placements=(table_grad, tok_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        table, tokens)
