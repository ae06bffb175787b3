"""The port's SSD and flash-attention wrappers against the reference's
Pallas kernels.

On the CPU the wrappers (``repro_torch.kernels.{ssd,flash_attention}.ops``)
take the plain PyTorch versions, which must compute what the Pallas kernels
compute: the same seeded inputs go through the reference's kernels in
interpret mode and its oracles (``mha_reference``, ``ssd_reference``, the
sequential recurrence), and through the port, on the sweeps of
``tests/test_kernels.py``.  Tolerances are the reference tests' own:
flash attention 2e-5 in float32 and 2e-2 in bfloat16, SSD 5e-3.

The CUDA kernels have no CPU mode: the ``cuda``-marked tests hold them
against the plain versions on the card and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as flash_pallas
from repro.kernels import ssd_pallas
from repro.kernels.flash_attention.ref import mha_reference
from repro.kernels.ssd.ref import ssd_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
SSD_TOL = dict(atol=5e-3, rtol=5e-3)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _f32(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------- attention
def _qkv(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32))


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
    @pytest.mark.parametrize("B,Sq,Skv,H,K,hd", [
        (1, 128, 128, 4, 2, 64),
        (2, 64, 192, 4, 4, 32),
        (1, 256, 256, 8, 2, 16),
        (2, 128, 128, 2, 1, 64),   # MQA
    ])
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


# --------------------------------------------------------------------- SSD
def _ssd_inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)) * 0.5,
            -np.abs(rng.standard_normal((B, S, H))) * 0.3,
            rng.standard_normal((B, S, G, N)) * 0.5,
            rng.standard_normal((B, S, G, N)) * 0.5)


def _port_ssd(X, A, Bm, Cm, chunk, dtype=torch.float32):
    return ssd_ops.ssd(_t(X, dtype), _t(A, dtype), _t(Bm, dtype),
                       _t(Cm, dtype), chunk)


class TestSSD:
    @pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
        (1, 128, 2, 16, 1, 32, 32),
        (2, 256, 4, 64, 2, 64, 64),
        (1, 96, 2, 32, 1, 16, 32),    # padded sequence
        (1, 128, 8, 16, 4, 16, 128),  # single chunk
    ])
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


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
class TestKernelsOnCard:
    def test_flash_kernel_matches_plain(self):
        if not torch.cuda.is_available():
            pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")
        for seed, (shape, causal, window, dtype) in enumerate([
                ((2, 64, 192, 4, 4, 32), False, None, torch.float32),
                ((1, 100, 100, 2, 2, 32), True, None, torch.float32),
                ((1, 256, 256, 2, 2, 32), True, 64, torch.float32),
                ((2, 300, 300, 32, 32, 80), True, None, torch.bfloat16)]):
            q, k, v = (_t(a, dtype).cuda() for a in _qkv(seed, *shape))
            before = flash_ops.LAUNCHES["flash_attention"]
            got = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window)
            assert flash_ops.LAUNCHES["flash_attention"] == before + 1
            want = flash_ops.ref.flash_attention(q, k, v, causal=causal,
                                                 window=window)
            tol = F32 if dtype == torch.float32 else BF16
            torch.testing.assert_close(got.float(), want.float(), **tol)

    def test_ssd_kernel_matches_plain(self):
        if not torch.cuda.is_available():
            pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")
        for seed, (shape, chunk, dtype) in enumerate([
                ((2, 256, 4, 64, 2, 64), 64, torch.float32),
                ((1, 96, 2, 32, 1, 16), 32, torch.float32),
                ((2, 300, 80, 64, 1, 64), 256, torch.bfloat16)]):
            args = [_t(a, dtype).cuda() for a in _ssd_inputs(seed, *shape)]
            before = ssd_ops.LAUNCHES["ssd"]
            y, st = ssd_ops.ssd(*args, chunk)
            assert ssd_ops.LAUNCHES["ssd"] == before + 1
            yr, sr = ssd_ops.ref.ssd(*args, chunk)
            tol = SSD_TOL if dtype == torch.float32 else BF16
            torch.testing.assert_close(y.float(), yr.float(), **tol)
            torch.testing.assert_close(st, sr, **SSD_TOL)
