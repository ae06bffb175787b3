"""The port's SSD and flash-attention wrappers against the reference's
Pallas kernels.

On the CPU the wrappers (``repro_torch.kernels.{ssd,flash_attention}.ops``)
take the plain PyTorch versions, which must compute what the Pallas kernels
compute: the same seeded inputs go through the reference's kernels in
interpret mode and its oracles (``mha_reference``, ``ssd_reference``, the
sequential recurrence), and through the port, on the sweeps of
``tests/test_kernels.py``.  Tolerances are the reference tests' own:
flash attention 2e-5 in float32 and 2e-2 in bfloat16, SSD 5e-3.

The backward (``flash_attention_bwd``, ``ssd_bwd``; the reference has no
backward kernel and trains through the XLA forms ``chunked_gqa_attention``
and ``ssd_chunked``): on the CPU the wrappers take the plain backward
functions, which are held within 1e-4 of the largest element of
``jax.vjp`` of those XLA forms, and within 1e-4 of autograd through the
port's plain forward (which also covers a row that sees no key, where the
XLA form's online softmax over the visited chunks differs from the dense
softmax by design).

Decode attention (``kernels.decode_attention``; the reference has no
kernel there, its decode is an einsum): on the CPU the wrapper takes the
plain version, held to the reference's ``decode_gqa_attention`` at the
same tolerances; the wrapper's checks, plan, fake and FLOP rule are held
here, the kernel on the card.

The CUDA kernels have no CPU mode: ``tests/test_torch_lm_kernels_card.py``
holds them against the plain versions on the card.  What the bf16
kernels compute is rehearsed here instead: plain torch emulations of their
arithmetic (tiles, passes and bf16 operand roundings, ``_flash_bf16`` and
``_ssd_three_pass`` below, test helpers only) are held against the plain
versions and against the reference's bf16 model path and Pallas kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as flash_pallas
from repro.kernels import ssd_pallas
from repro.kernels.flash_attention.ref import mha_reference
from repro.kernels.ssd.ref import ssd_reference
from repro.models.attention import chunked_gqa_attention
from repro.models.attention import decode_gqa_attention as j_decode
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import build
from repro_torch.kernels import dryrun as kernel_dryrun
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops

from torch_cases import (BF16, F32, FLASH_SHAPES, SSD_SHAPES, SSD_TOL,
                         _decode_case, _qkv, _ssd_inputs, _t)


def _f32(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------- attention
def _mha(q, k, v, **kw):
    mv = lambda a: jnp.moveaxis(jnp.asarray(a), 2, 1)  # noqa: E731
    return jnp.moveaxis(mha_reference(mv(q), mv(k), mv(v), **kw), 1, 2)


def _check_flash(q, k, v, *, causal=True, window=None, jdtype=jnp.float32,
                 tdtype=torch.float32, tol=F32):
    got = flash_ops.flash_attention(_t(q, tdtype), _t(k, tdtype),
                                    _t(v, tdtype), causal=causal,
                                    window=window)
    assert got.dtype == tdtype and got.shape == q.shape
    jq, jk, jv = (jnp.asarray(a, jdtype) for a in (q, k, v))
    want = flash_pallas(jq, jk, jv, causal=causal, window=window,
                        block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(
        _f32(got), _f32(_mha(jq, jk, jv, causal=causal, window=window)),
        **tol)


class TestFlashAttention:
    @pytest.mark.parametrize("B,Sq,Skv,H,K,hd", FLASH_SHAPES)
    @pytest.mark.parametrize("causal", [True, False])
    def test_sweep_f32(self, B, Sq, Skv, H, K, hd, causal):
        _check_flash(*_qkv(B * Sq + H, B, Sq, Skv, H, K, hd), causal=causal)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtypes(self, dtype):
        tol = BF16 if dtype == "bfloat16" else F32
        _check_flash(*_qkv(3, 1, 128, 128, 4, 2, 32), jdtype=jnp.dtype(dtype),
                     tdtype=getattr(torch, dtype), tol=tol)

    def test_sliding_window(self):
        _check_flash(*_qkv(4, 1, 256, 256, 2, 2, 32), window=64)

    def test_unaligned_seq(self):
        _check_flash(*_qkv(5, 1, 100, 100, 2, 2, 32))

    def test_zamba2_head_dim(self):
        """hd = 80 (zamba2-2.7b), which the TPU wrapper pads to 128."""
        _check_flash(*_qkv(6, 1, 96, 96, 4, 4, 80))


# ------------------------------------------------------- decode attention
class TestDecodeAttention:
    @pytest.mark.parametrize("B,cap,H,K,hd,kind,window", [
        (2, 40, 4, 4, 16, "fill", None),     # olmoe's G = 1
        (2, 40, 8, 1, 32, "full", None),     # MQA
        (3, 33, 6, 2, 16, "ring", 20),       # a ring cache under a window
        (2, 17, 4, 2, 16, "none", None),     # a row with no valid slot
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_reference(self, B, cap, H, K, hd, kind, window,
                                     dtype):
        """The plain version (what CPU tensors take) against the
        reference's ``decode_gqa_attention`` on the same inputs."""
        tdtype, tol = getattr(torch, dtype), (F32 if dtype == "float32"
                                              else BF16)
        args = _decode_case(B * cap + H, B, cap, H, K, hd, kind, tdtype)
        got = decode_ops.decode_attention(*args, window=window)
        jargs = [jnp.asarray(_f32(a), jnp.dtype(dtype)) for a in args[:3]]
        want = j_decode(*jargs, jnp.asarray(args[3].numpy()),
                        jnp.asarray(args[4].numpy()), window=window)
        assert got.dtype == tdtype and got.shape == args[0].shape
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


# --------------------------------------------------------------------- SSD
def _port_ssd(X, A, Bm, Cm, chunk, dtype=torch.float32):
    return ssd_ops.ssd(_t(X, dtype), _t(A, dtype), _t(Bm, dtype),
                       _t(Cm, dtype), chunk)


class TestSSD:
    @pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SHAPES)
    def test_sweep(self, B, S, H, P, G, N, chunk):
        X, A, Bm, Cm = _ssd_inputs(S + H, B, S, H, P, G, N)
        y, st = _port_ssd(X, A, Bm, Cm, chunk)
        assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
        f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        yp, sp = ssd_pallas(f(X), f(A), f(Bm), f(Cm), chunk=chunk,
                            interpret=True)
        np.testing.assert_allclose(_f32(y), _f32(yp), **SSD_TOL)
        np.testing.assert_allclose(_f32(st), _f32(sp), **SSD_TOL)
        mv = lambda a: jnp.moveaxis(f(a), 1, 2)  # noqa: E731
        yr, sr = ssd_reference(mv(X), mv(A), mv(Bm), mv(Cm), chunk=chunk)
        np.testing.assert_allclose(_f32(y), _f32(jnp.moveaxis(yr, 1, 2)),
                                   **SSD_TOL)
        np.testing.assert_allclose(_f32(st), _f32(sr), **SSD_TOL)

    def test_matches_sequential_recurrence(self):
        """Chunked scan == the naive per-step recurrence (ground truth)."""
        B, S, H, P, G, N = 1, 32, 2, 8, 1, 8
        X, A, Bm, Cm = _ssd_inputs(7, B, S, H, P, G, N)
        y, st = _port_ssd(X, A, Bm, Cm, 16)
        state = np.zeros((B, H, P, N))
        ys = []
        for t in range(S):
            b = np.repeat(Bm[:, t], H // G, 1)
            c = np.repeat(Cm[:, t], H // G, 1)
            state = state * np.exp(A[:, t])[..., None, None] + \
                np.einsum("bhn,bhp->bhpn", b, X[:, t])
            ys.append(np.einsum("bhn,bhpn->bhp", c, state))
        np.testing.assert_allclose(_f32(y), np.stack(ys, 1), **SSD_TOL)
        np.testing.assert_allclose(_f32(st), state, **SSD_TOL)

    def test_chunk_invariance(self):
        """The kernel carries its state every 64 rows whatever the model's
        chunk: the result may not depend on the chunk (reference pins 1e-4,
        ``tests/test_models.py::test_mamba_chunk_invariance``)."""
        X, A, Bm, Cm = _ssd_inputs(8, 1, 200, 4, 16, 2, 16)
        y16, s16 = _port_ssd(X, A, Bm, Cm, 16)
        for chunk in (ssd_ops.SUB_CHUNK, 256):
            y, s = _port_ssd(X, A, Bm, Cm, chunk)
            np.testing.assert_allclose(_f32(y), _f32(y16), atol=1e-4,
                                       rtol=1e-4)
            np.testing.assert_allclose(_f32(s), _f32(s16), atol=1e-4,
                                       rtol=1e-4)

    def test_bf16_computes_in_f32_inside(self):
        """bf16 in, y in bf16 and the state in float32, both from a float32
        scan of the bf16 inputs."""
        X, A, Bm, Cm = _ssd_inputs(11, 1, 64, 2, 16, 1, 16)
        rnd = lambda a: _f32(_t(a, torch.bfloat16))  # noqa: E731
        y, st = _port_ssd(X, A, Bm, Cm, 16, dtype=torch.bfloat16)
        assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
        y32, st32 = _port_ssd(rnd(X), rnd(A), rnd(Bm), rnd(Cm), 16)
        torch.testing.assert_close(st, st32, atol=0, rtol=0)
        torch.testing.assert_close(y, y32.to(torch.bfloat16), atol=0,
                                   rtol=0)


# ---------------------------------------------------------------- backward
def _close_to_max(got, want, tol=1e-4, what=""):
    """Within ``tol`` of the largest |want| (and of each element)."""
    want = _f32(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _jax_vjp(fn, args, cot):
    """``jax.vjp`` of ``fn`` at the float32 ``args`` against ``cot``, jitted
    (one compile instead of one per eager op)."""
    return jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(
        tuple(jnp.asarray(x, jnp.float32) for x in args), cot)


def _grads_of(fn, args, cot):
    """Autograd of the port's plain forward: ``fn(*args)`` against ``cot``."""
    leaves = [_t(a).requires_grad_() for a in args]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out, leaves, _t(cot))


class TestBackward:
    @pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window", [
        (1, 64, 64, 4, 1, 32, True, None),     # MQA
        (2, 48, 80, 4, 2, 16, False, None),
        (1, 96, 96, 2, 2, 32, True, 24),       # sliding window
        (1, 50, 50, 2, 2, 16, True, None),     # unaligned
        (1, 40, 40, 2, 2, 80, True, None),     # zamba2's hd
    ])
    def test_flash_bwd_matches_jax_vjp(self, B, Sq, Skv, H, K, hd, causal,
                                       window):
        q, k, v = _qkv(20 + Sq, B, Sq, Skv, H, K, hd)
        do = np.random.default_rng(Sq).standard_normal(q.shape)
        kw = dict(causal=causal, window=window)
        o, lse = flash_ops.ref.flash_attention_fwd(_t(q), _t(k), _t(v), **kw)
        got = flash_ops.flash_attention_bwd(_t(q), _t(k), _t(v), o, _t(do),
                                            lse, **kw)
        want = _jax_vjp(lambda a, b, c: chunked_gqa_attention(
            a, b, c, chunk_q=16, chunk_kv=16, **kw), (q, k, v),
            jnp.asarray(do, jnp.float32))
        auto = _grads_of(lambda a, b, c: flash_ops.ref.flash_attention(
            a, b, c, **kw), (q, k, v), do)
        for g, w, a, n in zip(got, want, auto, "qkv"):
            assert g.shape == a.shape and g.dtype == torch.float32
            _close_to_max(g, w, what=f"d{n} vs jax.vjp")
            _close_to_max(g, a, what=f"d{n} vs autograd")

    def test_flash_bwd_keyless_rows(self):
        """Queries past ``Skv + window - 1`` see no key: V averaged with
        weights 1/Skv, dQ zero; against autograd of the plain forward."""
        q, k, v = _qkv(30, 1, 96, 40, 2, 1, 16)
        do = np.random.default_rng(31).standard_normal(q.shape)
        kw = dict(causal=True, window=24)
        o, lse = flash_ops.ref.flash_attention_fwd(_t(q), _t(k), _t(v), **kw)
        got = flash_ops.flash_attention_bwd(_t(q), _t(k), _t(v), o, _t(do),
                                            lse, **kw)
        auto = _grads_of(lambda a, b, c: flash_ops.ref.flash_attention(
            a, b, c, **kw), (q, k, v), do)
        for g, a, n in zip(got, auto, "qkv"):
            _close_to_max(g, a, what=f"d{n}")
        assert not got[0][:, 40 + 24 - 1:].any()

    @pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
        (1, 128, 2, 16, 1, 32, 32),
        (2, 96, 4, 16, 2, 16, 64),    # padded sequence
        (1, 64, 8, 8, 4, 8, 16),      # G = 4
    ])
    @pytest.mark.parametrize("with_dfinal", [False, True])
    def test_ssd_bwd_matches_jax_vjp(self, B, S, H, P, G, N, chunk,
                                     with_dfinal):
        X, A, Bm, Cm = _ssd_inputs(40 + S, B, S, H, P, G, N)
        rng = np.random.default_rng(S + H)
        dY = rng.standard_normal(X.shape)
        dF = rng.standard_normal((B, H, P, N)) if with_dfinal \
            else np.zeros((B, H, P, N))
        got = ssd_ops.ssd_bwd(*(_t(a) for a in (X, A, Bm, Cm)), chunk,
                              _t(dY), _t(dF) if with_dfinal else None)
        f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        want = _jax_vjp(lambda *a: ssd_chunked(*a, chunk), (X, A, Bm, Cm),
                        (f(dY), f(dF)))
        leaves = [_t(a).requires_grad_() for a in (X, A, Bm, Cm)]
        y, fin = ssd_ops.ref.ssd(*leaves, chunk)
        auto = torch.autograd.grad((y * _t(dY)).sum() + (fin * _t(dF)).sum(),
                                   leaves)
        for g, w, a, n in zip(got, want, auto, ("X", "A", "Bm", "Cm")):
            assert g.shape == a.shape and g.dtype == torch.float32
            _close_to_max(g, w, what=f"d{n} vs jax.vjp")
            _close_to_max(g, a, what=f"d{n} vs autograd")

    def test_ssd_bwd_chunk_invariance(self):
        """The backward kernels chunk by ``CHUNK_BWD`` (float32) and
        ``CHUNK_BWD_BF16`` (bf16) rows whatever the model's chunk: the
        gradients may not depend on the chunk."""
        X, A, Bm, Cm = _ssd_inputs(50, 1, 200, 4, 16, 2, 16)
        dY = np.random.default_rng(51).standard_normal(X.shape)
        args = [_t(a) for a in (X, A, Bm, Cm)]
        base = ssd_ops.ssd_bwd(*args, 16, _t(dY))
        for chunk in (ssd_ops.CHUNK_BWD, ssd_ops.CHUNK_BWD_BF16):
            for g, w in zip(ssd_ops.ssd_bwd(*args, chunk, _t(dY)), base):
                _close_to_max(g, w)

    def test_autograd_function_routes_to_plain_backward(self):
        """A CPU tensor that requires grad goes through the wrappers'
        ``autograd.Function`` (forward with lse, plain backward) and counts
        no launch; its gradients equal autograd of the plain forward."""
        q, k, v = _qkv(60, 1, 32, 32, 4, 2, 16)
        X, A, Bm, Cm = _ssd_inputs(61, 1, 40, 4, 8, 2, 8)
        before = (dict(flash_ops.LAUNCHES), dict(ssd_ops.LAUNCHES))
        do = np.random.default_rng(62).standard_normal(q.shape)
        got = _grads_of(flash_ops.flash_attention, (q, k, v), do)
        want = _grads_of(flash_ops.ref.flash_attention, (q, k, v), do)
        for g, w in zip(got, want):
            _close_to_max(g, w)
        dY = np.random.default_rng(63).standard_normal(X.shape)
        got = _grads_of(lambda *a: ssd_ops.ssd(*a, 16), (X, A, Bm, Cm), dY)
        want = _grads_of(lambda *a: ssd_ops.ref.ssd(*a, 16), (X, A, Bm, Cm),
                         dY)
        for g, w in zip(got, want):
            _close_to_max(g, w)
        assert (flash_ops.LAUNCHES, ssd_ops.LAUNCHES) == before


# ------------------------------------------------------- wrapper contract
class TestWrapperContract:
    def test_flash_rejects_bad_inputs(self):
        q, k, v = (_t(a) for a in _qkv(12, 1, 32, 32, 4, 2, 16))
        with pytest.raises(TypeError):
            flash_ops.flash_attention(q.double(), k, v)
        with pytest.raises(TypeError):
            flash_ops.flash_attention(q, k.bfloat16(), v)
        with pytest.raises(ValueError):
            flash_ops.flash_attention(q, k[:, :16], v)
        with pytest.raises(ValueError):
            flash_ops.flash_attention(q.transpose(1, 2).contiguous()
                                      .transpose(1, 2), k, v)
        with pytest.raises(ValueError):  # 4 query heads over 3 KV heads
            flash_ops.flash_attention(q, *(_t(a) for a in
                                           _qkv(13, 1, 32, 32, 4, 3, 16)[1:]))
        with pytest.raises(ValueError):
            flash_ops.flash_attention(q, k, v, window=0)

    def test_decode_cpu_takes_plain_path(self):
        """A CPU tensor goes to the plain version, bitwise, through the
        model's entry point too; with this token's K/V rows, after the
        write ``append_kv`` makes.  No kernel launch is counted."""
        from repro_torch.models.attention import (append_kv,
                                                  decode_gqa_attention)
        decode_ops.reset_launches()
        for dtype in (torch.float32, torch.bfloat16):
            args = _decode_case(70, 2, 24, 4, 2, 16, "ring", dtype=dtype)
            want = decode_ops.ref.decode_attention(*args, window=9)
            for fn in (decode_ops.decode_attention, decode_gqa_attention):
                assert torch.equal(fn(*args, window=9), want)
            q, k, v, kvpos, pos = args
            new = torch.randn((2, 2, 1, 2, 16)).to(dtype)
            k2, v2 = k.clone(), v.clone()
            append_kv(k2, v2, new[0], new[1], pos)
            want = decode_ops.ref.decode_attention(q, k2, v2, kvpos, pos)
            for fn in (decode_ops.decode_attention, decode_gqa_attention):
                k3, v3 = k.clone(), v.clone()
                got = fn(q, k3, v3, kvpos, pos, k_new=new[0], v_new=new[1])
                assert torch.equal(got, want)
                assert torch.equal(k3, k2) and torch.equal(v3, v2)
        assert decode_ops.LAUNCHES["decode_attention"] == 0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_decode_fake_and_flop_rule(self, dtype):
        """Under a dry run the wrapper calls the operator: its fake gives
        the output's shape and dtype, and ``FlopCounterMode`` counts the
        FLOP rule, which equals its count of the plain version's two
        einsums at the same shapes (MHA and GQA)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        for B, cap, H, K, hd in ((2, 40, 4, 4, 16), (3, 65, 8, 2, 32)):
            args = _decode_case(71, B, cap, H, K, hd, dtype=dtype)
            with FlopCounterMode(display=False) as fc:
                decode_ops.ref.decode_attention(*args)
            plain = fc.get_total_flops()
            assert plain == decode_ops.flops(B, H, cap, hd) > 0
            new = torch.zeros((B, 1, K, hd), dtype=dtype)
            with FakeTensorMode() as mode, kernel_dryrun.dry_run():
                fake = [mode.from_tensor(a) for a in args]
                fnew = mode.from_tensor(new)
                with FlopCounterMode(display=False) as fc:
                    out = decode_ops.decode_attention(*fake, window=7,
                                                      k_new=fnew, v_new=fnew)
            assert out.shape == (B, 1, H, hd) and out.dtype == dtype
            assert fc.get_total_flops() == plain
        assert decode_ops.LAUNCHES["decode_attention"] == 0

    def test_decode_rejects_bad_inputs(self):
        q, k, v, kvpos, pos = _decode_case(72, 2, 24, 4, 2, 16)
        with pytest.raises(TypeError):           # dtype mismatch
            decode_ops.decode_attention(q, k.bfloat16(), v, kvpos, pos)
        with pytest.raises(TypeError):           # float64
            decode_ops.decode_attention(q.double(), k.double(), v.double(),
                                        kvpos, pos)
        with pytest.raises(TypeError):           # int64 positions
            decode_ops.decode_attention(q, k, v, kvpos, pos.long())
        with pytest.raises(ValueError):          # a non-contiguous cache
            decode_ops.decode_attention(
                q, k, v.transpose(1, 2).contiguous().transpose(1, 2), kvpos,
                pos)
        with pytest.raises(ValueError):          # hd not a multiple of 8
            decode_ops.decode_attention(
                *_decode_case(73, 2, 24, 4, 2, 12))
        with pytest.raises(ValueError):          # rows past 512 bytes
            decode_ops.decode_attention(
                *_decode_case(74, 1, 8, 2, 2, 136))
        with pytest.raises(ValueError):          # 4 query heads over 3
            decode_ops.decode_attention(
                q, *_decode_case(75, 2, 24, 4, 3, 16)[1:])
        with pytest.raises(ValueError):          # two query tokens
            decode_ops.decode_attention(torch.cat([q, q], 1), k, v, kvpos,
                                        pos)
        with pytest.raises(ValueError):
            decode_ops.decode_attention(q, k, v, kvpos, pos, window=0)
        new = torch.zeros((2, 1, 2, 16))
        with pytest.raises(ValueError):          # k_new without v_new
            decode_ops.decode_attention(q, k, v, kvpos, pos, k_new=new)
        with pytest.raises(ValueError):          # a row per KV head
            decode_ops.decode_attention(q, k, v, kvpos, pos,
                                        k_new=new[:, :, :1],
                                        v_new=new[:, :, :1])
        with pytest.raises(TypeError):
            decode_ops.decode_attention(q, k, v, kvpos, pos,
                                        k_new=new.bfloat16(),
                                        v_new=new.bfloat16())

    @pytest.mark.parametrize("B,K,G,cap", [
        (32, 16, 1, 1792), (32, 16, 1, 960), (8, 16, 1, 3853),
        (8, 16, 1, 781), (1, 8, 8, 4096), (2, 8, 6, 1000), (1, 1, 1, 5),
        (1, 8, 12, 32768)])
    def test_decode_plan(self, B, K, G, cap):
        """Whole tiles, every slot in one split, p of a split within the
        kernel's shared memory, one wave of eight blocks an SM filled where
        the cache is long enough, and scratch for the scores and the
        splits' partial sums."""
        split = decode_ops.plan(B, K, G, cap, 132)
        gt = min(8, 1 << (G - 1).bit_length())
        n = -(-cap // split)
        assert split % 32 == 0 and (n - 1) * split < cap <= n * split
        assert split <= min(1024, 2048 // gt)
        wave = 8 * 132 // (B * K * -(-G // gt))
        assert n >= min(wave, -(-cap // 256))
        H, hd = K * G, 128
        part = B * H * n * hd if n > 1 else 0
        assert decode_ops.scratch_bytes(B, H, K, cap, hd) == 4 * (
            -(-B * H * cap // 64) * 64 + part)

    def test_ssd_rejects_bad_inputs(self):
        X, A, Bm, Cm = (_t(a) for a in _ssd_inputs(14, 1, 32, 4, 8, 2, 8))
        with pytest.raises(TypeError):
            ssd_ops.ssd(X.double(), A, Bm, Cm, 16)
        with pytest.raises(TypeError):
            ssd_ops.ssd(X, A.bfloat16(), Bm, Cm, 16)
        with pytest.raises(ValueError):
            ssd_ops.ssd(X, A[:, :16], Bm, Cm, 16)
        with pytest.raises(ValueError):
            ssd_ops.ssd(X, A, Bm[..., ::2], Cm[..., ::2], 16)
        with pytest.raises(ValueError):
            ssd_ops.ssd(X, A, Bm, Cm, 0)


# ------------------------------------------- rehearsal of the bf16 kernels
def _bf(a):
    """Round to bf16 and back to float32 (an operand the kernel rounds)."""
    return a.to(torch.bfloat16).float()


def _flash_bf16(q, k, v, *, causal=True, window=None, block=128):
    """The bf16 flash kernel's arithmetic in plain torch (float32 values of
    bf16 tensors in the model layout): 128-row query blocks, key tiles of
    128 (hd <= 80) or 64 keys from the window's lower edge to
    the causal frontier, q.k of the bf16 operands scaled in float32 in the
    log2 domain, the finite -1e30 mask, an online softmax whose row sum
    takes the float32 p, and p rounded to bf16 for p.v with float32
    accumulation."""
    B, Sq, H, hd = q.shape
    bk = 128 if hd <= 80 else 64
    Skv, K = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                           # (B,H,Sq,hd)
    kf = k.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    scale_log2 = (1.0 / hd ** 0.5) * 1.4426950408889634
    out = torch.empty((B, H, Sq, hd))
    for q0 in range(0, Sq, block):
        rows = torch.arange(q0, min(q0 + block, Sq))[:, None]
        kv_end = min(Skv, q0 + block) if causal else Skv
        t_end = -(-kv_end // bk)
        t_begin = max(0, q0 - window + 1) // bk if window else 0
        t_begin = min(t_begin, t_end - 1)
        m = torch.full((B, H, len(rows)), flash_ops.ref.NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        o = torch.zeros((B, H, len(rows), hd))
        for t in range(t_begin, t_end):
            keys = torch.arange(t * bk, min((t + 1) * bk, Skv))[None]
            s = qf[:, :, q0:q0 + len(rows)] @ kf[:, :, keys[0]].transpose(
                -1, -2) * scale_log2
            ok = torch.ones((len(rows), keys.shape[1]), dtype=torch.bool)
            if causal:
                ok &= keys <= rows
            if window:
                ok &= keys > rows - window
            s = torch.where(ok, s, flash_ops.ref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            c = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * c + p.sum(-1)
            o = o * c[..., None] + _bf(p) @ vf[:, :, keys[0]]
            m = m_new
        out[:, :, q0:q0 + len(rows)] = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


def _ssd_three_pass(X, A, Bm, Cm, T, *, bf16=True):
    """The bf16 SSD kernel's three passes in plain torch, chunk T: (1) each
    chunk's state x^T (B o decay), (2) the states entering each chunk,
    (3) per chunk y = exp(cum) (C s_in^T) + ((C B^T) o L) x, where each
    operand the kernel computes (B o decay, s_in, (C B^T) o L) is a bf16 hi
    + lo pair.  With ``bf16=False`` nothing is rounded: the chunked dual
    form in float32."""
    def rnd(t):  # the hi + lo pair's value
        if not bf16:
            return t
        hi = _bf(t)
        return hi + _bf(t - hi)
    b, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // T)
    pad = nc * T - S

    def chunks(t):  # (b, S, ...) -> (b, nc, T, ...), zero tails
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(b, nc, T, *t.shape[2:])
    x, a = chunks(X), chunks(A)
    Bh = chunks(Bm).repeat_interleave(H // G, dim=3)        # (b,nc,T,H,N)
    Ch = chunks(Cm).repeat_interleave(H // G, dim=3)
    cum = torch.cumsum(a, dim=2)                             # (b,nc,T,H)
    bd = rnd(Bh * torch.exp(cum[:, :, -1:] - cum)[..., None])
    own = torch.einsum("bcthp,bcthn->bchpn", x, bd)
    run = torch.zeros((b, H, P, N))
    s_in = []
    for c in range(nc):
        s_in.append(rnd(run))
        run = run * torch.exp(cum[:, c, -1])[..., None, None] + own[:, c]
    s_in = torch.stack(s_in, 1)                              # (b,nc,H,P,N)
    y = torch.einsum("bcthn,bchpn->bcthp", Ch, s_in) * \
        torch.exp(cum)[..., None]
    lower = torch.ones((T, T), dtype=torch.bool).tril()[None, None, :, :,
                                                          None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,i,j,H)
    L = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0)
    g = rnd(torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * L)
    y = y + torch.einsum("bcijh,bcjhp->bcihp", g, x)
    return y.reshape(b, nc * T, H, P)[:, :S].to(X.dtype), run


_FLASH_CASES = [
    ((1, 128, 128, 4, 2, 64), True, None),
    ((2, 64, 192, 4, 4, 32), False, None),
    ((2, 128, 128, 2, 1, 64), True, None),     # MQA
    ((1, 256, 256, 8, 2, 16), True, None),
    ((1, 256, 256, 2, 2, 32), True, 64),       # window
    ((1, 100, 100, 2, 2, 32), True, None),     # unaligned S
    ((1, 300, 300, 2, 2, 80), True, None),     # zamba2's hd, 3 query blocks
]


class TestBf16Rehearsal:
    @pytest.mark.parametrize("shape,causal,window", _FLASH_CASES)
    def test_flash_emulation(self, shape, causal, window):
        """The bf16 kernel's arithmetic against the plain version, the
        reference's bf16 serving path and its Pallas kernel (2e-2)."""
        q, k, v = _qkv(sum(shape), *shape)
        tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
        got = _flash_bf16(tq, tk, tv, causal=causal, window=window)
        want = flash_ops.flash_attention(tq, tk, tv, causal=causal,
                                         window=window)
        torch.testing.assert_close(got.float(), want.float(), **BF16)
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        model = chunked_gqa_attention(jq, jk, jv, causal=causal,
                                      window=window)
        np.testing.assert_allclose(_f32(got), _f32(model), **BF16)
        pallas = flash_pallas(jq, jk, jv, causal=causal, window=window,
                              block_q=64, block_k=64, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas), **BF16)

    @pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
        (1, 128, 2, 16, 1, 32, 32),
        (2, 256, 4, 64, 2, 64, 64),
        (1, 96, 2, 32, 1, 16, 32),     # ragged tail
        (1, 128, 8, 16, 4, 16, 128),
        (1, 32, 2, 8, 1, 8, 16),       # P = N = 8
        (1, 300, 2, 16, 1, 128, 256),  # N = 128, two chunks of 256
    ])
    def test_ssd_emulation(self, B, S, H, P, G, N, chunk):
        """The three bf16 passes against the plain version on the same
        bf16 inputs and against the reference's Pallas kernel (interpret
        mode) on their float32 values: y 2e-2, the float32 state 5e-3."""
        X, A, Bm, Cm = (_t(a, torch.bfloat16) for a in
                        _ssd_inputs(S + N, B, S, H, P, G, N))
        y, st = _ssd_three_pass(X, A, Bm, Cm, ssd_ops.CHUNK_BF16)
        assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
        yr, sr = ssd_ops.ssd(X, A, Bm, Cm, chunk)
        torch.testing.assert_close(y.float(), yr.float(), **BF16)
        torch.testing.assert_close(st, sr, **SSD_TOL)
        f = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
        yp, sp = ssd_pallas(f(X), f(A), f(Bm), f(Cm), chunk=chunk,
                            interpret=True)
        np.testing.assert_allclose(_f32(y), _f32(yp), **BF16)
        np.testing.assert_allclose(_f32(st), _f32(sp), **SSD_TOL)

    @pytest.mark.parametrize("T", [64, 128, 256])
    def test_three_pass_is_the_scan(self, T):
        """Unrounded, the three passes are the plain scan in float32 for
        any chunk (the chunk-invariance tolerance, 1e-4)."""
        X, A, Bm, Cm = (_t(a) for a in _ssd_inputs(T, 2, 300, 4, 16, 2, 32))
        y, st = _ssd_three_pass(X, A, Bm, Cm, T, bf16=False)
        yr, sr = ssd_ops.ref.ssd(X, A, Bm, Cm, 64)
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(st, sr, atol=1e-4, rtol=1e-4)

    def test_tma_contract(self):
        """The bf16 kernels load rows with TMA: widths must be multiples of
        8 elements and base pointers 16-byte aligned, or the wrapper
        raises."""
        t = torch.zeros(64, dtype=torch.bfloat16)
        build.check_tma(8, 16, 80, t=t)
        with pytest.raises(ValueError):
            build.check_tma(8, 12, t=t)
        with pytest.raises(ValueError):
            build.check_tma(8, t=t[1:])

