"""CPU rehearsals of the bf16 backward kernels' designs.

The bf16 ``flash_attention_bwd`` and ``ssd_bwd`` kernels (``fbwd3`` and
``sbwd3`` in the two CUDA sources) have no CPU mode.  What they compute is
rehearsed here in plain torch (test helpers only, float32 values of bf16
tensors):

* ``_flash_bwd_bf16``: the row pass (lse log2(e), D = rowsum(dO o O)), the
  dQ kernel's 128-row blocks over 64-key tiles from the window's edge to the
  causal frontier and the dK/dV kernel's 128-key blocks over the G query
  heads and 64-row query tiles (diagonal down, window's end, key-less tail
  rows), each sum in tile order, P rounded to bf16 before P^T dO and dS
  rounded to bf16 as the operand of dQ and dK;
* ``_ssd_bwd_chunked``: the forward's chunks of 256 rows and its entering
  states as bf16 hi / lo pairs, each chunk's share of the state gradient
  (dY^T (C o exp(cum)), the decayed C as a hi / lo pair), the reverse pass
  of ds (a hi / lo pair), and the chunk gradients with the masked scores
  ((C B^T) o L, (dY x^T) o L) as hi / lo operands.

Each is held against the plain backward (``ref``) on the same bf16 inputs and
against ``jax.vjp`` of the reference's XLA forms
(``repro.models.attention.chunked_gqa_attention``,
``repro.models.mamba2.ssd_chunked``) on their float32 values, within 2e-2 of
each element plus 2e-2 of the tensor's largest (the bf16 tolerance that
``test_backward_kernels_match_plain`` in ``tests/test_torch_lm_kernels_card.py``
holds the kernels to on the card); unrounded, the SSD emulation is the plain
backward to 1e-4 at any chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_gqa_attention
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops

LOG2E = 1.4426950408889634
BF16_TOL = 2e-2


def _bf(t):
    """Round to bf16 and back to float32 (an operand the kernel rounds)."""
    return t.to(torch.bfloat16).float()


def _hilo(t):
    """The value of a bf16 hi + lo pair of t."""
    hi = _bf(t)
    return hi + _bf(t - hi)


def _close(got, want, tol=BF16_TOL, what=""):
    """Within ``tol`` of each element plus ``tol`` of the largest |want|."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else jnp.asarray(want, jnp.float32), np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _jax_vjp(fn, args, cot):
    return jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(
        tuple(jnp.asarray(x.float().numpy()) for x in args), cot)


# --------------------------------------------------------------- attention
def _flash_bwd_bf16(q, k, v, o, do, lse, *, causal=True, window=None):
    """The bf16 flash backward kernels' arithmetic (see the module doc)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / hd ** 0.5
    sl2 = scale * LOG2E
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    l2 = lse * LOG2E                                          # (B,H,Sq)
    D = (do.float() * o.float()).sum(-1).transpose(1, 2)     # (B,H,Sq)
    dead = Skv + window - 1 if window else float("inf")

    def ok(rows, keys):
        m = (rows[:, None] < Sq) & (keys[None] < Skv)
        if causal:
            m &= keys[None] <= rows[:, None]
        if window:
            m &= keys[None] > rows[:, None] - window
        return m

    # dQ: 128-row blocks, 64-key tiles over the forward's range
    kh = lambda t: t.repeat_interleave(G, dim=1)  # noqa: E731
    kq, vq = kh(kf), kh(vf)
    dq = torch.zeros((B, H, Sq, hd))
    for q0 in range(0, Sq, 128):
        rows = torch.arange(q0, min(q0 + 128, Sq))
        kv_end = min(Skv, q0 + 128) if causal else Skv
        t_end = -(-kv_end // 64)
        t_begin = min(max(0, q0 - window + 1) // 64 if window else 0,
                      t_end - 1)
        acc = torch.zeros((B, H, len(rows), hd))
        for t in range(t_begin, t_end):
            keys = torch.arange(64 * t, min(64 * t + 64, Skv))
            s = qf[:, :, rows] @ kq[:, :, keys].transpose(-1, -2)
            p = torch.exp2(s * sl2 - l2[:, :, rows, None])
            dp = dof[:, :, rows] @ vq[:, :, keys].transpose(-1, -2)
            ds = torch.where(ok(rows, keys), p * (dp - D[:, :, rows, None]),
                             0.0)
            acc = acc + _bf(ds) @ kq[:, :, keys]
        dq[:, :, rows] = acc * scale
    # dK, dV: 128-key blocks over the G heads and their 64-row query tiles
    qg = qf.reshape(B, K, G, Sq, hd)
    dg = dof.reshape(B, K, G, Sq, hd)
    l2g, Dg = l2.reshape(B, K, G, Sq), D.reshape(B, K, G, Sq)
    dk = torch.zeros((B, K, Skv, hd))
    dv = torch.zeros((B, K, Skv, hd))
    for k0 in range(0, Skv, 128):
        keys = torch.arange(k0, min(k0 + 128, Skv))
        lo = k0 if causal else 0
        hi = min(Sq, k0 + 127 + window) if window else Sq
        adk = torch.zeros((B, K, len(keys), hd))
        adv = torch.zeros((B, K, len(keys), hd))
        for g in range(G):
            for t in range(lo // 64, -(-Sq // 64)):
                q0 = 64 * t
                if q0 >= hi and q0 + 64 <= dead:
                    continue
                rows = torch.arange(q0, min(q0 + 64, Sq))
                st = kf[:, :, keys] @ qg[:, :, g, rows].transpose(-1, -2)
                p = torch.exp2(st * sl2 - l2g[:, :, g, None, rows])
                dpt = vf[:, :, keys] @ dg[:, :, g, rows].transpose(-1, -2)
                m = ok(rows, keys).T
                keyless = (rows[None] >= dead) & (keys[:, None] < Skv)
                pt = torch.where(m, p, torch.where(keyless, 1.0 / Skv, 0.0))
                dst = torch.where(m, p * (dpt - Dg[:, :, g, None, rows]), 0.0)
                adv = adv + _bf(pt) @ dg[:, :, g, rows]
                adk = adk + _bf(dst) @ qg[:, :, g, rows]
        dk[:, :, keys] = adk * scale
        dv[:, :, keys] = adv
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _bf16_qkv(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    f = lambda *sz: torch.as_tensor(  # noqa: E731
        rng.standard_normal(sz), dtype=torch.float32).to(torch.bfloat16)
    return f(B, Sq, H, hd), f(B, Skv, K, hd), f(B, Skv, K, hd), \
        f(B, Sq, H, hd)


_FLASH_BWD_CASES = [
    ((1, 64, 64, 4, 1, 32), True, None),       # MQA
    ((2, 48, 80, 4, 2, 16), False, None),
    ((1, 96, 96, 2, 2, 32), True, 24),         # sliding window
    ((1, 50, 50, 2, 2, 16), True, None),       # unaligned
    ((1, 40, 40, 2, 2, 80), True, None),       # zamba2's hd
    ((1, 192, 96, 2, 2, 32), True, 64),        # key-less rows
    ((1, 300, 300, 4, 4, 80), True, None),     # crosses 128-row tiles
    ((2, 384, 384, 8, 2, 80), True, None),     # GQA, three blocks
    ((1, 320, 200, 4, 4, 80), True, 64),       # window, key-less rows
]


@pytest.mark.parametrize("shape,causal,window", _FLASH_BWD_CASES)
def test_flash_bwd_emulation(shape, causal, window):
    """The bf16 backward's tiles and roundings against the plain backward
    and ``jax.vjp`` of the reference's XLA form (where every row sees a
    key: the XLA form's online softmax differs from the dense one on a row
    that sees none, by design)."""
    q, k, v, do = _bf16_qkv(sum(shape) + (window or 0), *shape)
    kw = dict(causal=causal, window=window)
    o, lse = flash_ops.ref.flash_attention_fwd(q, k, v, **kw)
    got = _flash_bwd_bf16(q, k, v, o, do, lse, **kw)
    want = flash_ops.ref.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for g, w, n in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close(g, w, what=f"d{n} vs plain")
    Sq, Skv = shape[1], shape[2]
    if window is None or Sq < Skv + window - 1:
        ref = _jax_vjp(lambda a, b, c: chunked_gqa_attention(
            a, b, c, chunk_q=16, chunk_kv=16, **kw), (q, k, v),
            jnp.asarray(do.float().numpy()))
        for g, w, n in zip(got, ref, "qkv"):
            _close(g, w, what=f"d{n} vs jax.vjp")
    else:  # rows that see no key: dQ is zero there
        assert not got[0][:, Skv + window - 1:].float().any()


# --------------------------------------------------------------------- SSD
def _ssd_bwd_chunked(X, A, Bm, Cm, dY, dfinal=None, *, T=256, bf16=True):
    """The bf16 SSD backward's passes (see the module doc), chunk T; with
    ``bf16=False`` nothing is rounded: the chunked backward in float32."""
    rnd = _hilo if bf16 else (lambda t: t)
    b, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // T)
    pad = nc * T - S

    def chunks(t):  # (b, S, ...) -> (b, nc, T, ...), zero tails
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(b, nc, T, *t.shape[2:])
    x, a, dy = chunks(X), chunks(A), chunks(dY)
    Bh = chunks(Bm).repeat_interleave(H // G, dim=3)         # (b,nc,T,H,N)
    Ch = chunks(Cm).repeat_interleave(H // G, dim=3)
    cum = torch.cumsum(a, dim=2)                              # (b,nc,T,H)
    last = cum[:, :, -1]                                      # (b,nc,H)
    e_out = torch.exp(last[:, :, None] - cum)
    e_in = torch.exp(cum)
    # the forward's passes 1 and 2: the entering states as hi / lo pairs
    own = torch.einsum("bcthp,bcthn->bchpn", x, rnd(Bh * e_out[..., None]))
    run = torch.zeros((b, H, P, N))
    s_in = []
    for c in range(nc):
        s_in.append(rnd(run))
        run = run * torch.exp(last[:, c])[..., None, None] + own[:, c]
    s_in = torch.stack(s_in, 1)                               # (b,nc,H,P,N)
    # each chunk's share of the state gradient, then ds in reverse
    gown = torch.einsum("bcthp,bcthn->bchpn", dy, rnd(Ch * e_in[..., None]))
    run = torch.zeros((b, H, P, N)) if dfinal is None else dfinal.float()
    ds, w = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        ds[c] = rnd(run)
        w[c] = torch.exp(last[:, c]) * (run * s_in[:, c]).sum((-1, -2))
        run = run * torch.exp(last[:, c])[..., None, None] + gown[:, c]
    ds, w = torch.stack(ds, 1), torch.stack(w, 1)             # w (b,nc,H)
    # the chunk gradients
    lower = torch.ones((T, T), dtype=torch.bool).tril()[None, None, :, :,
                                                          None]
    diff = cum[:, :, :, None] - cum[:, :, None]               # (b,nc,i,j,H)
    L = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0)
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    dg = torch.einsum("bcihp,bcjhp->bcijh", dy, x)
    t = cb * dg * L
    dx = torch.einsum("bcijh,bcihp->bcjhp", rnd(cb * L), dy) + e_out[..., None] \
        * torch.einsum("bchpn,bcjhn->bcjhp", ds, Bh)
    dB_st = e_out[..., None] * torch.einsum("bchpn,bcjhp->bcjhn", ds, x)
    dB = torch.einsum("bcijh,bcihn->bcjhn", rnd(dg * L), Ch) + dB_st
    dC_in = e_in[..., None] * torch.einsum("bchpn,bcihp->bcihn", s_in, dy)
    dC = torch.einsum("bcijh,bcjhn->bcihn", rnd(dg * L), Bh) + dC_in
    u = (Ch * dC_in).sum(-1)                                  # (b,nc,T,H)
    v = (Bh * dB_st).sum(-1)
    dcum = t.sum(3) - t.sum(2) + u - v
    dcum[:, :, -1] += w + v.sum(2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])

    def rows(t):
        return t.reshape(b, nc * T, *t.shape[3:])[:, :S]
    fold = lambda t: t.reshape(b, S, G, H // G, N).sum(3)  # noqa: E731
    return (rows(dx).to(X.dtype), rows(da).to(A.dtype),
            fold(rows(dB)).to(Bm.dtype), fold(rows(dC)).to(Cm.dtype))


def _ssd_inputs(seed, B, S, H, P, G, N, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dtype)  # noqa
    return (f(rng.standard_normal((B, S, H, P)) * 0.5),
            f(-np.abs(rng.standard_normal((B, S, H))) * 0.3),
            f(rng.standard_normal((B, S, G, N)) * 0.5),
            f(rng.standard_normal((B, S, G, N)) * 0.5),
            f(rng.standard_normal((B, S, H, P))))


_SSD_BWD_CASES = [
    (1, 128, 2, 16, 1, 32, 32),
    (2, 96, 4, 16, 2, 16, 64),      # padded sequence
    (1, 64, 8, 8, 4, 8, 16),        # G = 4
    (1, 300, 2, 16, 1, 64, 256),    # two chunks of 256
    (1, 600, 8, 64, 1, 64, 256),    # three chunks, zamba2's P and N
    (2, 520, 4, 32, 2, 32, 256),    # crosses 256-row chunks, G = 2
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", _SSD_BWD_CASES)
@pytest.mark.parametrize("with_dfinal", [False, True])
def test_ssd_bwd_emulation(B, S, H, P, G, N, chunk, with_dfinal):
    """The bf16 backward's passes and roundings against the plain backward
    and ``jax.vjp`` of the reference's ``ssd_chunked``."""
    X, A, Bm, Cm, dY = _ssd_inputs(S + H + N, B, S, H, P, G, N)
    dF = torch.as_tensor(np.random.default_rng(S).standard_normal(
        (B, H, P, N)), dtype=torch.float32) if with_dfinal else None
    got = _ssd_bwd_chunked(X, A, Bm, Cm, dY, dF)
    want = ssd_ops.ref.ssd_bwd(X, A, Bm, Cm, chunk, dY, dF)
    for g, w, n in zip(got, want, ("X", "A", "Bm", "Cm")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close(g, w, what=f"d{n} vs plain")
    dFj = jnp.asarray(dF.numpy()) if with_dfinal \
        else jnp.zeros((B, H, P, N), jnp.float32)
    ref = _jax_vjp(lambda *a: ssd_chunked(*a, chunk), (X, A, Bm, Cm),
                   (jnp.asarray(dY.float().numpy()), dFj))
    for g, w, n in zip(got, ref, ("X", "A", "Bm", "Cm")):
        _close(g, w, what=f"d{n} vs jax.vjp")


@pytest.mark.parametrize("T", [64, 128, 256])
def test_ssd_bwd_chunked_is_the_plain_backward(T):
    """Unrounded, the passes are the plain backward in float32 for any
    chunk (the chunk-invariance tolerance, 1e-4 of the largest)."""
    X, A, Bm, Cm, dY = _ssd_inputs(T, 2, 300, 4, 16, 2, 32, torch.float32)
    dF = torch.as_tensor(np.random.default_rng(T).standard_normal(
        (2, 4, 16, 32)), dtype=torch.float32)
    got = _ssd_bwd_chunked(X, A, Bm, Cm, dY, dF, T=T, bf16=False)
    want = ssd_ops.ref.ssd_bwd(X, A, Bm, Cm, 64, dY, dF)
    for g, w, n in zip(got, want, ("X", "A", "Bm", "Cm")):
        _close(g, w, tol=1e-4, what=f"d{n}")
