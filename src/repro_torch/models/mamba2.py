"""Mamba2 (state-space duality) mixer: chunked SSD, causal conv, decode.

Counterpart of the reference's ``models/mamba2.py``.  Prefill's chunked
scan is :func:`repro_torch.kernels.ssd.ops.ssd`, the counterpart of the
reference's ``ssd_chunked``: the hand-written kernel on CUDA, its plain
float32 version on the CPU.  There is no ``ssd_impl`` switch.  The
prefill's elementwise work on either side of the scan goes through
:func:`repro_torch.kernels.mamba2_mix.ops.mixer`: on CUDA two hand-written
kernels (``mix_in``: conv, SiLU, softplus, the scan's inputs; ``mix_out``:
``Y + D x``, the gate, the RMSNorm), on the CPU the plain version, which
calls :func:`causal_conv1d` and :func:`split_zxbcdt` below.  The one-token
decode (``ssd_decode_step``, ``conv_decode_step``) is plain PyTorch: the
reference has no kernel for it.  ``p`` is the ``mamba`` module of a
``repro_torch.models.blocks.Mamba2Block``.  On DTensors (a mesh) the causal
conv runs on each device's batch rows and channels through ``local_map``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.mamba2_mix import ops as mix_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.partitioning import gathered
from repro_torch.models.layers import rmsnorm

__all__ = ["ssd_decode_step", "causal_conv1d", "conv_decode_step",
           "mamba2_mixer", "mamba2_decode"]


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One recurrent step in float32.  state (B,H,P,N); x (B,H,P) not
    pre-multiplied by dt; dt (B,H); A (H,); Bm/Cm (B,G,N).
    Returns ``(y (B,H,P), new_state)``."""
    rep = state.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1)                  # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A[None, :])                        # (B,H)
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, x)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    return y, new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width KW.  x (B,S,C), w (C,KW), b (C,)."""
    if isinstance(x, DTensor):
        return _conv_sharded(x, w, b)
    kw, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, kw - 1, 0))
    wd = w.to(x.dtype)
    y = 0
    for i in range(kw):  # the reference's summation order, in x's dtype
        y = y + xp[:, i:i + S, :] * wd[None, None, :, i]
    return y + b.to(x.dtype)[None, None, :]


def _conv_sharded(x, w, b):
    """:func:`causal_conv1d` of DTensors: each device convolves its batch
    rows and, where x's channels are split evenly, its channels, over the
    whole sequence (the conv is depthwise).  The weights are whole on the
    batch axes, where each device reads them for its own rows: their
    gradients are partial sums there."""
    mesh = x.device_mesh
    C = x.shape[2]
    x_pl, w_pl, w_grad = [], [], []
    for p, m in zip(x.placements, mesh.shape):
        if p == Shard(0):
            x_pl.append(p)
            w_pl.append(Replicate())
            w_grad.append(Partial())
        elif p == Shard(2) and C % m == 0:
            x_pl.append(p)
            w_pl.append(Shard(0))
            w_grad.append(Shard(0))
        else:
            x_pl.append(Replicate())
            w_pl.append(Replicate())
            w_grad.append(Replicate())
    return local_map(causal_conv1d, out_placements=x_pl,
                     in_placements=(x_pl, w_pl, w_pl),
                     in_grad_placements=(x_pl, w_grad, w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, w, b)


def conv_decode_step(conv_state: torch.Tensor, x_new: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor):
    """conv_state (B,KW-1,C); x_new (B,C).  Returns (y (B,C), new_state)."""
    full = torch.cat([conv_state.to(x_new.dtype), x_new[:, None, :]], dim=1)
    y = torch.einsum("bkc,ck->bc", full, w.to(x_new.dtype)) \
        + b.to(x_new.dtype)[None, :]
    return y, full[:, 1:, :]


def split_zxbcdt(zxbcdt, d_inner, conv_dim):
    """``(z, xBC, dt_raw)``: views of the in-projection's output."""
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., d_inner + conv_dim:])


def mamba2_mixer(p, cfg, u: torch.Tensor):
    """The Mamba2 mix for prefill.  u: (B, S, d_model).

    Returns ``(out, final_ssm_state, conv_tail)``; ``conv_tail`` is the last
    KW-1 pre-conv inputs, the conv state that decoding continues from.
    """
    S = u.shape[1]
    din, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    dtype = u.dtype

    zxbcdt = u @ gathered(p.in_proj, dtype)
    _, xBC, _ = split_zxbcdt(zxbcdt, din, din + 2 * G * N)
    kw = p.conv_w.shape[1]
    # a copy, not a view: a view would keep the whole (B, S, zdim)
    # projection of every layer alive in the cache
    conv_tail = xBC[:, -(kw - 1):, :].clone() if S >= kw - 1 else F.pad(
        xBC, (0, 0, kw - 1 - S, 0))
    y, final = mix_ops.mixer(
        zxbcdt, p, cfg, lambda *scan_in: ssd_ops.ssd(*scan_in, cfg.ssm_chunk))
    return y @ gathered(p.out_proj, dtype), final, conv_tail


def mamba2_decode(p, cfg, u: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor):
    """One-token decode.  u: (B, 1, d_model).

    Returns ``(out (B,1,d), new_conv_state, new_ssm_state)``.
    """
    B_ = u.shape[0]
    din, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    dtype = u.dtype

    zxbcdt = u[:, 0] @ gathered(p.in_proj, dtype)
    z, xBC, dt_raw = split_zxbcdt(zxbcdt, din, din + 2 * G * N)
    xBC, new_conv = conv_decode_step(conv_state, xBC, p.conv_w, p.conv_b)
    xBC = F.silu(xBC)
    x = xBC[..., :din].reshape(B_, H, P)
    Bm = xBC[..., din:din + G * N].reshape(B_, G, N)
    Cm = xBC[..., din + G * N:].reshape(B_, G, N)

    dt = F.softplus(dt_raw.float() + p.dt_bias.float())  # (B,H)
    A = -torch.exp(p.A_log.float())
    y, new_state = ssd_decode_step(ssm_state.float(), x.float(), dt, A,
                                   Bm.float(), Cm.float())
    y = y.to(dtype) + p.D.to(dtype)[None, :, None] * x
    y = rmsnorm(y.reshape(B_, din) * F.silu(z), p.norm_scale, cfg.norm_eps)
    out = y @ gathered(p.out_proj, dtype)
    return out[:, None, :], new_conv, new_state.to(ssm_state.dtype)
