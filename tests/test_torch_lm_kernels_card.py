"""The SSD, flash-attention and decode-attention kernels on the card,
forward and backward, against their plain versions on the same CUDA
tensors.

Tolerances are the CPU tests' (``tests/test_torch_lm_kernels.py``): flash
attention 2e-5 in float32 and 2e-2 in bf16, the SSD 5e-3 (its bf16 y
2e-2); the backward within 1e-4 of each element and of the tensor's
largest in float32, 2e-2 of each in bf16, against the plain backward and
against autograd through the plain forward.  The cases are the union of
the CPU tests' sweeps and shapes that cross the bf16 kernels' 128-row
tiles and 256-row chunks, each in both dtypes where the kernel takes
both.
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from torch_cases import (BF16, DECODE_CHECKED, F32, FLASH_SHAPES, SSD_SHAPES,
                         SSD_TOL, _decode_case, _qkv, _ssd_inputs, _t)

DTYPES = (torch.float32, torch.bfloat16)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")


def _case_id(kernel, shape, *rest):
    return " ".join([kernel, "x".join(map(str, shape))]
                    + [str(r).removeprefix("torch.") for r in rest])


# (shape, causal, window): the CPU sweep both ways, a window, an unaligned
# S and zamba2's hd 80, each in both dtypes; then serving-like bf16 shapes
FLASH_ON_CARD = [
    (shape, causal, window, dtype)
    for shape, causal, window in (
        [(s, c, None) for s in FLASH_SHAPES for c in (True, False)]
        + [((1, 256, 256, 2, 2, 32), True, 64),
           ((1, 100, 100, 2, 2, 32), True, None),
           ((1, 96, 96, 4, 4, 80), True, None)])
    for dtype in DTYPES] + [
    ((2, 300, 300, 32, 32, 80), True, None, torch.bfloat16),
    ((1, 200, 200, 4, 2, 128), True, None, torch.bfloat16)]

# (shape, chunk): the CPU sweep and P = N = 8 in both dtypes, then the
# bf16 kernel's 256-row chunks at zamba2's heads and at P = N = 128
SSD_ON_CARD = [(s[:6], s[6], dtype)
               for s in SSD_SHAPES + [(1, 32, 2, 8, 1, 8, 16)]
               for dtype in DTYPES] + [
    ((2, 300, 80, 64, 1, 64), 256, torch.bfloat16),
    ((1, 300, 4, 128, 2, 128), 256, torch.bfloat16)]

# the backward: MQA, non-causal GQA, a window with rows that see no key,
# an unaligned S and hd 80; then rows across the bf16 kernel's 128-row
# tiles (S = 300, GQA at S = 384, a window with key-less rows at hd 80,
# GQA at hd 128), each in both dtypes; zamba2's heads at S = 300 in bf16
FLASH_BWD_ON_CARD = [
    (shape, causal, window, dtype)
    for shape, causal, window in [
        ((1, 128, 128, 4, 1, 64), True, None),
        ((2, 64, 192, 4, 2, 32), False, None),
        ((1, 192, 96, 2, 2, 32), True, 64),
        ((1, 100, 100, 2, 2, 32), True, None),
        ((1, 96, 96, 4, 4, 80), True, None),
        ((1, 300, 300, 4, 4, 80), True, None),
        ((2, 384, 384, 8, 2, 80), True, None),
        ((1, 320, 200, 4, 4, 80), True, 64),
        ((1, 200, 200, 4, 2, 128), True, None)]
    for dtype in DTYPES] + [
    ((1, 300, 300, 32, 32, 80), True, None, torch.bfloat16)]

# chunks of 32 / 64 / 128, S = 96 and a padded S = 100, G = 2 and 4, then
# S = 600, 520 and 300 across the bf16 kernel's 256-row chunks, the last
# at P = N = 128, each in both dtypes; S = 100 at G = 2 in float32 and
# zamba2's heads over one and three chunks in bf16
SSD_BWD_ON_CARD = [
    (shape[:6], shape[6], dtype)
    for shape in [(1, 128, 2, 16, 1, 32, 32), (2, 256, 4, 64, 2, 64, 64),
                  (1, 96, 2, 32, 1, 16, 32), (1, 100, 2, 32, 1, 16, 64),
                  (1, 128, 8, 16, 4, 16, 128), (1, 600, 8, 64, 1, 64, 256),
                  (2, 520, 4, 32, 2, 32, 256), (1, 300, 4, 128, 2, 128, 256)]
    for dtype in DTYPES] + [
    ((1, 100, 4, 32, 2, 16), 64, torch.float32),
    ((1, 300, 80, 64, 1, 64), 256, torch.bfloat16),
    ((2, 600, 8, 64, 2, 64), 256, torch.bfloat16)]


def _bwd_close(got, want, dtype, what):
    """float32: within 1e-4 of each element and of the tensor's largest
    |want|; bf16: 2e-2 of each element plus 2e-2 of the largest."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale, msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize(
        "shape,causal,window,dtype",
        [pytest.param(*c, id=_case_id("flash", *c)) for c in FLASH_ON_CARD])
    def test_flash_kernel_matches_plain(self, shape, causal, window, dtype):
        _need_card()
        q, k, v = (_t(a, dtype).cuda() for a in _qkv(sum(shape), *shape))
        before = flash_ops.LAUNCHES["flash_attention"]
        got = flash_ops.flash_attention(q, k, v, causal=causal,
                                        window=window)
        assert flash_ops.LAUNCHES["flash_attention"] == before + 1
        want = flash_ops.ref.flash_attention(q, k, v, causal=causal,
                                             window=window)
        tol = F32 if dtype == torch.float32 else BF16
        torch.testing.assert_close(got.float(), want.float(), **tol)

    @pytest.mark.parametrize(
        "shape,chunk,dtype",
        [pytest.param(*c, id=_case_id("ssd", *c)) for c in SSD_ON_CARD])
    def test_ssd_kernel_matches_plain(self, shape, chunk, dtype):
        _need_card()
        args = [_t(a, dtype).cuda()
                for a in _ssd_inputs(sum(shape) + chunk, *shape)]
        before = ssd_ops.LAUNCHES["ssd"]
        y, st = ssd_ops.ssd(*args, chunk)
        assert ssd_ops.LAUNCHES["ssd"] == before + 1
        yr, sr = ssd_ops.ref.ssd(*args, chunk)
        tol = SSD_TOL if dtype == torch.float32 else BF16
        torch.testing.assert_close(y.float(), yr.float(), **tol)
        torch.testing.assert_close(st, sr, **SSD_TOL)

    @pytest.mark.parametrize(
        "kernel,case",
        [pytest.param("flash", c, id=_case_id("flash_bwd", *c))
         for c in FLASH_BWD_ON_CARD]
        + [pytest.param("ssd", c, id=_case_id("ssd_bwd", *c))
           for c in SSD_BWD_ON_CARD])
    def test_backward_kernels_match_plain(self, kernel, case):
        """Each backward kernel against its plain version and against
        autograd through the plain forward; the forward kernel's ``lse``
        against the plain one where every row sees a key; the bf16 SSD
        through ``_SSD``, which hands the backward the forward's entering
        states, bitwise the gradients of the call without them."""
        _need_card()
        gen = torch.Generator(device="cuda").manual_seed(5)
        if kernel == "flash":
            shape, causal, window, dtype = case
            q, k, v = (_t(a, dtype).cuda()
                       for a in _qkv(sum(shape), *shape))
            kw = dict(causal=causal, window=window)
            o, lse = flash_ops.ref.flash_attention_fwd(q, k, v, **kw)
            do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
            before = flash_ops.LAUNCHES["flash_attention_bwd"]
            got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            assert flash_ops.LAUNCHES["flash_attention_bwd"] == before + 1
            want = flash_ops.ref.flash_attention_bwd(q, k, v, o, do, lse,
                                                     **kw)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(
                flash_ops.ref.flash_attention(*leaves, **kw), leaves, do)
            for g, w, a, n in zip(got, want, auto, "qkv"):
                _bwd_close(g, w, dtype, f"d{n}")
                _bwd_close(g, a, dtype, f"d{n} vs autograd")
            if window is None:
                _, lse_k = flash_ops._forward(q, k, v, causal, window,
                                              with_lse=True)
                tol = F32 if dtype == torch.float32 else BF16
                torch.testing.assert_close(lse_k, lse, **tol)
            return
        shape, chunk, dtype = case
        args = [_t(a, dtype).cuda()
                for a in _ssd_inputs(sum(shape) + chunk, *shape)]
        dY = torch.randn(args[0].shape, generator=gen,
                         device="cuda").to(dtype)
        before = ssd_ops.LAUNCHES["ssd_bwd"]
        got = ssd_ops.ssd_bwd(*args, chunk, dY)
        assert ssd_ops.LAUNCHES["ssd_bwd"] == before + 1
        want = ssd_ops.ref.ssd_bwd(*args, chunk, dY)
        leaves = [a.detach().clone().requires_grad_() for a in args]
        auto = torch.autograd.grad(ssd_ops.ref.ssd(*leaves, chunk)[0],
                                   leaves, dY)
        for g, w, a, n in zip(got, want, auto, ("X", "A", "Bm", "Cm")):
            _bwd_close(g, w, dtype, f"d{n}")
            _bwd_close(g, a, dtype, f"d{n} vs autograd")
        if dtype == torch.bfloat16:
            leaves = [a.detach().clone().requires_grad_() for a in args]
            y, _ = ssd_ops.ssd(*leaves, chunk)
            saved = torch.autograd.grad(y, leaves, dY)
            for g, a in zip(got, saved):
                assert torch.equal(g, a)


@pytest.mark.cuda
class TestDecodeKernelOnCard:
    """The decode-attention kernel against the plain version on the same
    CUDA tensors, and against a float32 computation of the same function
    (the plain version on the inputs' float32 values: q scaled and p kept
    in float32).  Tolerances: float32, the kernel and the plain version
    differ only in the order of float32 sums, 2e-5; bf16, a different
    order can move a pre-rounding p or output across a bf16 rounding
    boundary, one or two bf16 ulps of the output (2^-8 relative each), so
    1e-2; against the float32 function, bf16's roundings of q.scale, p and
    the output, the flash tests' 2e-2."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_plain(self, dtype):
        from repro_torch.models.attention import append_kv
        _need_card()
        tdtype = getattr(torch, dtype)
        for seed, (B, cap, H, K, hd, kind, window) in enumerate(
                DECODE_CHECKED):
            if dtype == "float32" and hd * 4 > decode_ops.MAX_ROW_BYTES:
                continue
            args = _decode_case(seed, B, cap, H, K, hd, kind, tdtype, "cuda")
            before = decode_ops.LAUNCHES["decode_attention"]
            got = decode_ops.decode_attention(*args, window=window)
            torch.cuda.synchronize()
            assert decode_ops.LAUNCHES["decode_attention"] == before + 1
            assert got.dtype == tdtype and got.shape == args[0].shape
            want = decode_ops.ref.decode_attention(*args, window=window)
            tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            f32 = decode_ops.ref.decode_attention(
                *(a.float() for a in args[:3]), *args[3:], window=window)
            tol = F32 if dtype == "float32" else BF16
            torch.testing.assert_close(got.float(), f32, **tol)
            # with this token's rows: written bitwise, then attended to
            q, k, v, kvpos, pos = args
            new = torch.randn((2, B, 1, K, hd), device="cuda").to(tdtype)
            k2, v2 = k.clone(), v.clone()
            append_kv(k2, v2, new[0], new[1], pos)
            want = decode_ops.ref.decode_attention(q, k2, v2, kvpos, pos,
                                                   window=window)
            got = decode_ops.decode_attention(q, k, v, kvpos, pos,
                                              window=window, k_new=new[0],
                                              v_new=new[1])
            assert torch.equal(k, k2) and torch.equal(v, v2)
            tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
            torch.testing.assert_close(got.float(), want.float(), **tol)

    def test_one_token_and_bitwise_repeat(self):
        """B = 1, and two calls on the same inputs bitwise equal (no
        atomics decide a sum) at a split cache."""
        _need_card()
        for B, cap in ((1, 1792), (8, 3853)):
            args = _decode_case(40 + B, B, cap, 16, 16, 128, "fill",
                                dtype=torch.bfloat16, device="cuda")
            a = decode_ops.decode_attention(*args)
            b = decode_ops.decode_attention(*args)
            assert torch.equal(a, b)
            torch.testing.assert_close(
                a.float(), decode_ops.ref.decode_attention(*args).float(),
                atol=1e-2, rtol=1e-2)

    def test_one_launch_per_layer_in_a_decode_step(self):
        """A smoke olmoe decode step on the card: every layer's decode
        attention goes through the kernel, one call each."""
        _need_card()
        from repro_torch.configs import smoke_config
        from repro_torch.models import decode_step, init_params, prefill
        cfg = smoke_config("olmoe-1b-7b")
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        toks = torch.randint(0, cfg.vocab, (2, 12), dtype=torch.int32,
                             device="cuda")
        _, cache = prefill(model, cfg, {"tokens": toks}, capacity=16)
        before = decode_ops.LAUNCHES["decode_attention"]
        for t in range(2):
            decode_step(model, cfg, {"tokens": toks[:, t]}, cache,
                        torch.full((2,), 12 + t, dtype=torch.int32,
                                   device="cuda"))
        torch.cuda.synchronize()
        assert decode_ops.LAUNCHES["decode_attention"] - before \
            == 2 * cfg.n_layers


@pytest.mark.cuda
class TestBf16KernelsAtServingWidth:
    def test_flash(self):
        """zamba2-2.7b's prefill attention at one request: (1, 2048, 32,
        80), causal."""
        _need_card()
        q, k, v = (_t(a, torch.bfloat16).cuda()
                   for a in _qkv(21, 1, 2048, 2048, 32, 32, 80))
        got = flash_ops.flash_attention(q, k, v, causal=True)
        want = flash_ops.ref.flash_attention(q, k, v, causal=True)
        torch.testing.assert_close(got.float(), want.float(), **BF16)

    def test_ssd(self):
        """zamba2-2.7b's Mamba2 scan at one request: x (1, 2048, 80, 64),
        G = 1, N = 64, the model's chunk of 256."""
        _need_card()
        args = [_t(a, torch.bfloat16).cuda()
                for a in _ssd_inputs(22, 1, 2048, 80, 64, 1, 64)]
        y, st = ssd_ops.ssd(*args, 256)
        yr, sr = ssd_ops.ref.ssd(*args, 256)
        torch.testing.assert_close(y.float(), yr.float(), **BF16)
        torch.testing.assert_close(st, sr, **SSD_TOL)

    def test_flash_bwd(self):
        """The bf16 attention backward at zamba2-2.7b's training shape:
        (1, 2048, 32, 80), causal; 2e-2 of each element plus 2e-2 of the
        tensor's largest."""
        _need_card()
        q, k, v = (_t(a, torch.bfloat16).cuda()
                   for a in _qkv(23, 1, 2048, 2048, 32, 32, 80))
        o, lse = flash_ops.ref.flash_attention_fwd(q, k, v, causal=True)
        do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        want = flash_ops.ref.flash_attention_bwd(q, k, v, o, do, lse,
                                                 causal=True)
        for g, w in zip(got, want):
            scale = float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2 * scale)

    def test_ssd_bwd(self):
        """The bf16 SSD backward at zamba2-2.7b's training shape: x (1,
        2048, 80, 64), G = 1, N = 64, eight chunks of 256."""
        _need_card()
        args = [_t(a, torch.bfloat16).cuda()
                for a in _ssd_inputs(24, 1, 2048, 80, 64, 1, 64)]
        dY = torch.randn(args[0].shape, device="cuda").to(torch.bfloat16)
        got = ssd_ops.ssd_bwd(*args, 256, dY)
        want = ssd_ops.ref.ssd_bwd(*args, 256, dY)
        for g, w in zip(got, want):
            scale = float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2 * scale)
