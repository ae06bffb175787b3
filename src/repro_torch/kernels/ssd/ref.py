"""Plain PyTorch version of the SSD kernel: the chunked scan in float32.

The counterpart of the reference's ``models/mamba2.py::ssd_chunked`` in the
model layout, computed in float32 inside as the kernel does (the reference
form computes in its input dtype).  It walks the chunks in order and
carries the state between them, the way the kernel does:

* ``cum = cumsum(a)`` within the chunk;
* ``L[i, j] = exp(cum_i - cum_j)`` for ``i >= j``, else 0 (the exponent is
  evaluated on the lower triangle only: above it ``exp`` can overflow);
* ``y = ((C Bᵀ) ∘ L) x + (C ∘ exp(cum)) stateᵀ``;
* ``state ← state · exp(cum_last) + xᵀ (B ∘ exp(cum_last − cum))``.

A last chunk shorter than ``chunk`` equals one padded with zeros (``x = 0``
adds nothing, ``a = 0`` keeps the state).  Used for CPU tensors and as the
kernel's oracle on the card.
"""

from __future__ import annotations

import torch

__all__ = ["ssd"]


def ssd(X: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int):
    """X (B,S,H,P) pre-multiplied by dt; A (B,S,H) log-decays; Bm/Cm
    (B,S,G,N).  Returns ``(Y (B,S,H,P) in X's dtype, final (B,H,P,N) f32)``.
    """
    b, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    x, a = X.float(), A.float()
    Bh = Bm.float().repeat_interleave(rep, dim=2)  # (b,S,H,N): head h → h//rep
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=X.device)
    ys = []
    for s0 in range(0, S, chunk):
        xs, bs, cs = x[:, s0:s0 + chunk], Bh[:, s0:s0 + chunk], \
            Ch[:, s0:s0 + chunk]
        cum = torch.cumsum(a[:, s0:s0 + chunk], dim=1)        # (b,l,H)
        l = cum.shape[1]
        lower = torch.ones((l, l), dtype=torch.bool,
                           device=X.device).tril()[None, :, :, None]
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (b,i,j,H)
        L = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0)
        scores = torch.einsum("bihn,bjhn->bijh", cs, bs) * L
        y = torch.einsum("bijh,bjhp->bihp", scores, xs)
        y = y + torch.einsum("bihn,bhpn->bihp",
                             cs * torch.exp(cum)[..., None], state)
        decay = torch.exp(cum[:, -1:] - cum)                  # (b,l,H)
        state = state * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("bjhp,bjhn->bhpn", xs, bs * decay[..., None])
        ys.append(y)
    return torch.cat(ys, dim=1).to(X.dtype), state
