"""Plain PyTorch version of the flash-attention kernels: dense masked softmax.

The counterpart of the reference's ``flash_attention/ref.py::mha_reference``
in the model layout, in float32: GQA (query head h reads KV head h // G),
causal mask aligned top-left (key k visible to query q when k <= q), an
optional sliding window (k > q - window).  Two choices follow the kernel
rather than ``mha_reference``: q is scaled (by ``1/sqrt(hd)`` unless a
``scale`` is given) in float32 before the product (``kernel.py:55``), and
masked scores take the finite
``-1e30`` (``kernel.py:30``), so a row with no visible key averages V
instead of turning NaN.  Used for CPU tensors and as the kernels' oracle on
the card.

:func:`flash_attention_fwd` also returns the row log-sum-exp ``lse`` (B, H,
Sq) float32 that the backward reads, and :func:`flash_attention_bwd` is the
explicit backward from the saved tensors: with ``P = exp(s - lse)``,
``D = rowsum(dO o O)`` and ``dS = P o (dO V^T - D)`` (zero where masked),
``dV = P^T dO``, ``dQ = scale dS K`` and ``dK = scale dS^T Q``, the G query
heads of a KV head summed into its dK and dV.  A row that sees no key (a
window past the end of the keys) has ``lse = -1e30`` too, which cannot hold
the log of its key count, so its uniform weights ``1/Skv`` are restored
explicitly; its dQ and its share of dK are zero.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "default_scale", "flash_attention",
           "flash_attention_fwd", "flash_attention_bwd"]

NEG_INF = -1e30


def default_scale(hd: int) -> float:
    """The softmax scale when none is given, ``1/sqrt(hd)``."""
    return 1.0 / hd ** 0.5


def _dense(q, k, v, causal, window, scale):
    """Scaled q, k and v per query head in float32 (B, H, S, hd), the
    masked scores (B, H, Sq, Skv) and the mask (Sq, Skv)."""
    Sq, H, hd = q.shape[1], q.shape[2], q.shape[3]
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = default_scale(hd)
    qf = q.float().transpose(1, 2) * scale                    # (B,H,Sq,hd)
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
    return qf, kf, vf, torch.where(mask, s, NEG_INF), mask


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd).  Returns ``(out (B,Sq,H,hd) in q's
    dtype, lse (B,H,Sq) float32)``."""
    _, _, vf, s, _ = _dense(q, k, v, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    out = (p @ vf).transpose(1, 2).to(q.dtype).contiguous()
    return out, torch.logsumexp(s, dim=-1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd).  Returns (B,Sq,H,hd) in q's dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The gradients of :func:`flash_attention` from the saved ``q, k, v``,
    the output ``o``, its gradient ``do`` and the forward's ``lse``.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = default_scale(hd)
    qf, kf, vf, s, mask = _dense(q, k, v, causal, window, scale)
    seen = mask.any(dim=-1, keepdim=True)                     # (Sq, 1)
    p = torch.where(seen, torch.exp(s - lse[..., None]), 1.0 / Skv)
    dof = do.float().transpose(1, 2)                          # (B,H,Sq,hd)
    dv = p.transpose(-1, -2) @ dof                            # (B,H,Skv,hd)
    dp = dof @ vf.transpose(-1, -2)
    D = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dp - D), 0.0)
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qf
    fold = lambda t: t.reshape(B, K, H // K, Skv, hd).sum(2)  # noqa: E731
    return (dq.transpose(1, 2).to(q.dtype),
            fold(dk).transpose(1, 2).to(k.dtype),
            fold(dv).transpose(1, 2).to(v.dtype))
