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
kernels' oracle on the card.

:func:`ssd_bwd` is the explicit backward from the saved inputs and ``dY``.
It recomputes the state entering each chunk, then walks the chunks in
reverse carrying ``dstate``, the gradient of the state leaving the chunk
(``dfinal`` for the last one, zero when the final state is unused):

* ``dx_j = Σ_i G_ij dy_i + e_j (dstate B_j)`` with ``G = (C Bᵀ) ∘ L`` and
  ``e_j = exp(cum_last − cum_j)``;
* ``dC_i = Σ_j (dy_i·x_j) L_ij B_j + exp(cum_i) stateᵀ dy_i``;
* ``dB_j = Σ_i (dy_i·x_j) L_ij C_i + e_j dstateᵀ x_j``;
* ``dcum`` from the three places ``cum`` enters (``L`` by both indices, the
  entering state's ``exp(cum_i)``, the outgoing state's decay), then
  ``da`` as its reverse cumsum within the chunk;
* ``dstate ← dstate · exp(cum_last) + Σ_i exp(cum_i) dy_i ⊗ C_i``.

B and C gradients are taken per head and summed over the heads of a group.
"""

from __future__ import annotations

import torch

__all__ = ["ssd", "ssd_bwd"]


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


def _lower(l, device):
    return torch.ones((l, l), dtype=torch.bool,
                      device=device).tril()[None, :, :, None]


def _decay(cum, lower):
    """``L[b, i, j, h] = exp(cum_i − cum_j)`` on the lower triangle, else 0
    (the exponent is evaluated there only)."""
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    return torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0)


def ssd_bwd(X: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int, dY: torch.Tensor,
            dfinal: torch.Tensor = None):
    """The gradients of :func:`ssd` from its inputs, ``dY`` (B,S,H,P) and
    the final state's gradient ``dfinal`` (B,H,P,N) or None (zero).
    Returns ``(dX, dA, dBm, dCm)`` in the inputs' dtypes."""
    b, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    x, a, dy = X.float(), A.float(), dY.float()
    Bh = Bm.float().repeat_interleave(rep, dim=2)
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    starts = list(range(0, S, chunk))
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=X.device)
    entering, cums = [], []
    for s0 in starts:
        sl = slice(s0, s0 + chunk)
        cum = torch.cumsum(a[:, sl], dim=1)                   # (b,l,H)
        entering.append(state)
        cums.append(cum)
        decay = torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("bjhp,bjhn->bhpn", x[:, sl], Bh[:, sl]
                         * decay[..., None])
    dstate = torch.zeros_like(state) if dfinal is None else dfinal.float()
    dx, da = torch.empty_like(x), torch.empty_like(a)
    dB, dC = torch.empty_like(Bh), torch.empty_like(Ch)
    for s0, cum, st in zip(reversed(starts), reversed(cums),
                           reversed(entering)):
        sl = slice(s0, s0 + chunk)
        xs, dys, bs, cs = x[:, sl], dy[:, sl], Bh[:, sl], Ch[:, sl]
        L = _decay(cum, _lower(cum.shape[1], X.device))       # (b,i,j,H)
        CB = torch.einsum("bihn,bjhn->bijh", cs, bs)
        dG = torch.einsum("bihp,bjhp->bijh", dys, xs)
        e_in = torch.exp(cum)                                 # (b,l,H)
        e_out = torch.exp(cum[:, -1:] - cum)
        e_last = torch.exp(cum[:, -1])                        # (b,H)
        dGL = dG * L
        t = dGL * CB
        dx_st = torch.einsum("bhpn,bjhn->bjhp", dstate, bs) * e_out[..., None]
        dx[:, sl] = torch.einsum("bijh,bihp->bjhp", CB * L, dys) + dx_st
        dC_in = torch.einsum("bhpn,bihp->bihn", st, dys) * e_in[..., None]
        dC[:, sl] = torch.einsum("bijh,bjhn->bihn", dGL, bs) + dC_in
        dB_st = torch.einsum("bhpn,bjhp->bjhn", dstate, xs) * e_out[..., None]
        dB[:, sl] = torch.einsum("bijh,bihn->bjhn", dGL, cs) + dB_st
        u = (cs * dC_in).sum(-1)                              # (b,l,H)
        v = (bs * dB_st).sum(-1)
        dcum = t.sum(2) - t.sum(1) + u - v
        w = e_last * (dstate * st).sum((-1, -2))              # (b,H)
        dcum[:, -1] += w + v.sum(1)
        da[:, sl] = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        dstate = dstate * e_last[..., None, None] + torch.einsum(
            "bihp,bihn->bhpn", dys * e_in[..., None], cs)
    fold = lambda t: t.reshape(b, S, G, rep, N).sum(3)  # noqa: E731
    return (dx.to(X.dtype), da.to(A.dtype), fold(dB).to(Bm.dtype),
            fold(dC).to(Cm.dtype))
