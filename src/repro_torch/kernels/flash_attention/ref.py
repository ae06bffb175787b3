"""Plain PyTorch version of the flash-attention kernel: dense masked softmax.

The counterpart of the reference's ``flash_attention/ref.py::mha_reference``
in the model layout, in float32: GQA (query head h reads KV head h // G),
causal mask aligned top-left (key k visible to query q when k <= q), an
optional sliding window (k > q - window).  Two choices follow the kernel
rather than ``mha_reference``: q is scaled by ``1/sqrt(hd)`` in float32
before the product (``kernel.py:55``), and masked scores take the finite
``-1e30`` (``kernel.py:30``), so a row with no visible key averages V
instead of turning NaN.  Used for CPU tensors and as the kernel's oracle on
the card.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "flash_attention"]

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd).  Returns (B,Sq,H,hd) in q's dtype."""
    Sq, H, hd = q.shape[1], q.shape[2], q.shape[3]
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().transpose(1, 2) * (1.0 / hd ** 0.5)        # (B,H,Sq,hd)
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    s = qf @ kf.transpose(-1, -2)                             # (B,H,Sq,Skv)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return (p @ vf).transpose(1, 2).to(q.dtype)
