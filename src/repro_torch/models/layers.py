"""Shared layers: RMSNorm, rotary embedding, SwiGLU MLP, embedding lookup.

Counterparts of the reference's ``models/layers.py``, with its dtype rules:
the norm and the rotation run in float32 and cast back; weights are cast
to the activations' dtype at each use.  M-RoPE (``apply_mrope``) waits for
the vlm family.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "swiglu", "rope_frequencies", "apply_rope",
           "embed_lookup"]


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
    g = x @ w_gate.to(dtype)
    u = x @ w_up.to(dtype)
    return (F.silu(g) * u) @ w_down.to(dtype)


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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather with a cast to the compute dtype."""
    return table[tokens.long()].to(dtype)
