"""Plain PyTorch version of the Mamba2 mix kernels.

The port's Mamba2 prefill mixer between its two products
(``models/mamba2.py::mamba2_mixer``, the reference's
``models/mamba2.py::mamba2_mixer`` in PyTorch): :func:`mixer` is the whole
of it around a scan, cut there into :func:`mix_in` (from the
in-projection's output to the scan's inputs: causal conv, SiLU, softplus,
``x * dt`` and ``dt * A`` rounded to the compute dtype) and :func:`mix_out`
(from the scan's output to the out-projection's input: ``Y + D x``, the
gate, the float32 RMSNorm).  Used for CPU tensors (a CPU mesh's DTensors
among them), as the kernels' backward (recomputed and differentiated) and
as their oracle on the card.  :func:`case` draws the seeded inputs that the
tests and ``chip_smoke.py`` check the kernels on.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F

__all__ = ["mixer", "mix_in", "mix_out", "conv_x", "case"]


def mixer(zxbcdt, p, cfg, scan):
    """``(y, final_state)``: the mixer from the in-projection's output
    ``zxbcdt`` (B, S, Z) to the out-projection's input ``y`` (B, S,
    d_inner); ``scan(X, Adt, Bm, Cm)`` gives ``(Y, final_state)``."""
    X, Adt, Bm, Cm, x = mix_in(zxbcdt, p.conv_w, p.conv_b, p.dt_bias,
                               p.A_log, cfg.d_inner, cfg.ssm_groups,
                               cfg.ssm_state)
    Y, final = scan(X, Adt, Bm, Cm)
    return mix_out(Y, zxbcdt, x, p.D, p.norm_scale, cfg.norm_eps), final


def mix_in(zxbcdt, conv_w, conv_b, dt_bias, A_log, d_inner, groups, state):
    """The scan's inputs from the in-projection's output (B, S, Z).

    Returns ``(X (B,S,H,P), Adt (B,S,H), Bm, Cm (B,S,G,N), x (B,S,H,P))``:
    ``x`` is the conv's output before ``dt``, which :func:`mix_out` adds
    back through ``D``."""
    # imported here: repro_torch.models imports this module
    from repro_torch.models.mamba2 import causal_conv1d, split_zxbcdt
    B_, S, _ = zxbcdt.shape
    din, G, N = d_inner, groups, state
    H = dt_bias.shape[0]
    P = din // H
    dtype = zxbcdt.dtype
    _, xBC, dt_raw = split_zxbcdt(zxbcdt, din, din + 2 * G * N)
    xBC = F.silu(causal_conv1d(xBC, conv_w, conv_b))
    x = xBC[..., :din].reshape(B_, S, H, P)
    Bm = xBC[..., din:din + G * N].reshape(B_, S, G, N).contiguous()
    Cm = xBC[..., din + G * N:].reshape(B_, S, G, N).contiguous()

    dt = F.softplus(dt_raw.float() + dt_bias.float())  # (B,S,H)
    A = -torch.exp(A_log.float())                       # (H,)

    # cast to the compute dtype before the scan, as the reference does
    X = (x.float() * dt[..., None]).to(dtype)
    Adt = (dt * A[None, None, :]).to(dtype)
    return X, Adt, Bm, Cm, x


def conv_x(zxbcdt, conv_w, conv_b, heads):
    """:func:`mix_in`'s ``x`` (B, S, H, P) from the conv's x channels alone
    (the conv is depthwise: the same values)."""
    from repro_torch.models.mamba2 import causal_conv1d
    B_, S, Z = zxbcdt.shape
    din = Z - heads - conv_w.shape[0]   # Z = 2 din + 2 G N + H
    x = F.silu(causal_conv1d(zxbcdt[..., din:2 * din], conv_w[:din],
                             conv_b[:din]))
    return x.reshape(B_, S, heads, din // heads)


def mix_out(Y, zxbcdt, x, D, norm_scale, eps):
    """The out-projection's input (B, S, din) from the scan's output
    ``Y`` (B,S,H,P), the gate ``z`` (the in-projection's first din
    columns) and :func:`mix_in`'s ``x``."""
    from repro_torch.models.layers import rmsnorm
    B_, S, H, P = Y.shape
    din = H * P
    dtype = Y.dtype
    z = zxbcdt[..., :din]
    Y = Y + D.to(dtype)[None, None, :, None] * x
    y = Y.reshape(B_, S, din)
    return rmsnorm(y * F.silu(z), norm_scale, eps)


def case(cfg, B, S, dtype=torch.bfloat16, device="cpu", seed=0):
    """Seeded mixer inputs at ``cfg``'s widths on ``device``: ``(p, zx,
    Y)``, ``p`` a Mamba2 layer's float32 parameters (``in_proj``,
    ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``, ``D``, ``norm_scale``,
    ``out_proj``) drawn at the scales ``models.blocks.mamba2_param_defs``
    gives them, ``zx`` an in-projection output (B, S, Z) and ``Y`` a scan
    output (B, S, H, P), both unit normal in ``dtype``."""
    from repro_torch.models.blocks import CONV_KW
    g = torch.Generator(device=device).manual_seed(seed)
    D, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    GN = cfg.ssm_groups * cfg.ssm_state
    C, Z = din + 2 * GN, 2 * din + 2 * GN + H

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    dt = torch.exp(torch.rand((H,), generator=g, device=device)
                   * math.log(100.0) + math.log(1e-3))
    p = types.SimpleNamespace(
        in_proj=rnd(D, Z, scale=D ** -0.5),
        conv_w=rnd(C, CONV_KW, scale=0.3),
        conv_b=rnd(C, scale=0.1),
        dt_bias=dt + torch.log(-torch.expm1(-dt)),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        D=1.0 + rnd(H, scale=0.1),
        norm_scale=1.0 + rnd(din, scale=0.1),
        out_proj=rnd(din, D, scale=din ** -0.5))
    zx = rnd(B, S, Z).to(dtype)
    Y = rnd(B, S, H, din // H).to(dtype)
    return p, zx, Y
