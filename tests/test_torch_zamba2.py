"""Zamba2's own form of the hybrid (``Zamba2Config``: two alternating shared
blocks over the stream and the embeddings side by side, a LoRA adapter
and a linear a use) against the benchmark's plain float32 reference,
``perfbench/reference/hybrid.py``, at a small size on the CPU with seeded
weights made by the benchmark's ``perfbench/weights.py``; the softmax
``scale`` of the attention kernels' CPU paths; and, marked ``cuda``, the
bf16 hd-160 kernels against their plain versions on the card.

Tolerances: float32 program against float32 reference, the same function
in another order of sums (the program's chunked SSD and flash attention,
the reference's closed-form chunks and dense softmax) over six layers:
1e-4 of the logits' scale.  A scale of ``1/sqrt(hd)`` where Zamba2 takes
``(hd / 2) ** -0.5`` moves the logits by more than 100 times that.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import weights as W
from perfbench.program import build_model
from perfbench.reference import hybrid as ref
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.roofline import model_flops
from repro_torch.models import blocks
from repro_torch.models.config import Zamba2Config
from repro_torch.models.model import (cache_shapes, decode_step,
                                      param_shapes, prefill)

HD = 32
SMALL = dict(n_layers=6, d_model=64, vocab=256, ssm_state=16, ssm_headdim=16,
             ssm_chunk=16, n_heads=4, n_kv_heads=4, head_dim=HD, d_ff=96,
             hybrid_layer_ids=(2, 4, 5), num_mem_blocks=2, adapter_rank=4,
             dtype="float32")
TOL = 1e-4
SEED = 2 ** 31 + 17


def _cfg(**over):
    return dataclasses.replace(get_config("zamba2-2.7b-zyphra"),
                               **dict(SMALL, **over))


def _model(cfg, seed=SEED):
    m = dataclasses.asdict(cfg)
    params = W.make(ref.param_defs(m), seed, "cpu")
    return build_model(cfg, params), params, m


def _tokens(B, S, seed=3):
    return torch.randint(0, SMALL["vocab"], (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want, tol=TOL):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


def _serve(model, cfg, prompts, served):
    """The program's logits (B, n, V) at the served positions: a prefill,
    then the served tokens but the last fed back a decode step each."""
    B, S = prompts.shape
    n = served.shape[1]
    logits, cache = prefill(model, cfg, {"tokens": prompts},
                            capacity=S + n)
    out = [logits]
    for j in range(n - 1):
        pos = torch.full((B,), S + j, dtype=torch.int32)
        logits, cache = decode_step(model, cfg, {"tokens": served[:, j]},
                                    cache, pos)
        out.append(logits)
    return torch.cat(out, dim=1), cache


@pytest.mark.parametrize("S", [20, 37])
def test_prefill_matches_the_reference(S):
    cfg = _cfg()
    model, params, m = _model(cfg)
    prompts = _tokens(2, S)
    got, _ = prefill(model, cfg, {"tokens": prompts})
    want = ref.serve_logits(params, m, prompts, prompts[:, :1])
    _close(got, want)


def test_prefill_then_decode_through_the_cache():
    """A prefill and 4 decode steps against the reference's full forward;
    the cache holds K/V a use and the recurrent state a Mamba2 layer."""
    cfg = _cfg()
    model, params, m = _model(cfg)
    prompts, served = _tokens(3, 21), _tokens(3, 5, seed=4)
    got, cache = _serve(model, cfg, prompts, served)
    _close(got, ref.serve_logits(params, m, prompts, served))
    shapes = cache_shapes(cfg, 3, 26)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: s for k, (s, _) in shapes.items()}
    assert shapes["k"][0][:3] == (3, 3, 26)          # uses, batch, capacity
    assert shapes["ssm"][0] == (6, 3, 8, 16, 16)     # layers, B, H, P, N
    assert shapes["conv"][0] == (6, 3, 3, 160)


def test_perturbing_block_1_leaves_the_stream_before_its_first_use():
    """Block 1's first use is use 1, before layer 4: the stream entering
    layer 4 is bitwise the same, the logits are not."""
    cfg = _cfg()
    model, _, _ = _model(cfg)
    prompts = _tokens(2, 16)
    seen = []
    model.blocks[4].register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    base, _ = prefill(model, cfg, {"tokens": prompts})
    with torch.no_grad():
        for p in model.shared[1].parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    bumped, _ = prefill(model, cfg, {"tokens": prompts})
    assert torch.equal(seen[0], seen[1])
    assert (base - bumped).abs().max() > 100 * TOL * base.abs().max()


@pytest.mark.parametrize("u", [0, 2])
def test_a_zeroed_adapter_gives_the_plain_shared_mlp(u):
    cfg = _cfg()
    model, _, _ = _model(cfg)
    blk = model.shared[u % 2].mlp
    use = model.uses[u]
    a = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(u))
    with torch.no_grad():
        use.adapter_a.zero_()
        got = blocks._shared_mlp(blk, use, cfg, a)
    n = blocks.rmsnorm(a, blk.ln, cfg.norm_eps)
    want = (F.gelu(n @ blk.w_gate) * (n @ blk.w_up)) @ blk.w_down
    _close(got, want, 1e-6)
    with torch.no_grad():
        use.adapter_a.normal_(0, 0.5)
        moved = blocks._shared_mlp(blk, use, cfg, a)
    assert (moved - want).abs().max() > 1e-3 * want.abs().max()


@pytest.mark.parametrize("scale,matches", [((HD / 2) ** -0.5, True),
                                           (None, False)])
def test_the_scale_is_half_the_head_dim(monkeypatch, scale, matches):
    """The reference scales by ``(hd / 2) ** -0.5``; the program matches it
    with that scale, and fails with the kernels' default ``1/sqrt(hd)``."""
    cfg = _cfg()
    assert cfg.attn_scale == (HD / 2) ** -0.5
    monkeypatch.setattr(Zamba2Config, "attn_scale", property(
        lambda self: scale))
    model, params, m = _model(cfg)
    prompts, served = _tokens(2, 18), _tokens(2, 3, seed=5)
    got, _ = _serve(model, cfg, prompts, served)
    want = ref.serve_logits(params, m, prompts, served)
    err = float((got - want).abs().max() / want.abs().max())
    assert (err <= TOL) == matches, err


def test_counts_of_the_published_form():
    """Zamba2-2.7B at its widths: 2.74 B parameters (two blocks, 9 uses'
    adapters and linears, 54 Mamba2 layers, untied head), 3.77 B weights
    a token meets outside the embedding and head; the dry run's model
    FLOPs count each use."""
    cfg = get_config("zamba2-2.7b-zyphra")
    assert cfg.attn_scale == 80 ** -0.5
    shapes = param_shapes(cfg)
    exact = sum(int(np.prod(s)) for s in shapes.values())
    assert abs(cfg.params_count() - exact) < 1e-3 * exact
    assert 2.74e9 < exact < 2.75e9
    assert shapes["shared.1.attn.wq"] == (5120, 5120)
    assert shapes["shared.0.attn.wo"] == (5120, 2560)
    assert shapes["uses.8.adapter_a"] == (2560, 128)
    assert shapes["uses.8.adapter_gate"] == (128, 10240)
    assert shapes["uses.8.linear"] == (2560, 2560)
    assert len([k for k in shapes if k.endswith(".in_proj")]) == 54
    met = cfg.active_params_count() - 2 * cfg.vocab * cfg.d_model
    assert 3.76e9 < met < 3.78e9
    B, S = 32, 32768                                  # prefill_32k
    attn = 9 * 4 * 160 * 32 * (B * S * (S + 1) // 2)
    want = 2.0 * (met + cfg.vocab * cfg.d_model) * B * S + attn
    assert model_flops(cfg, "prefill_32k") == pytest.approx(want, rel=1e-12)


# ----------------------------------------------------- the softmax scale
def _qkv(seed, B, S, H, K, hd):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, H, hd, generator=g),
            torch.randn(B, S, K, hd, generator=g),
            torch.randn(B, S, K, hd, generator=g))


@pytest.mark.parametrize("scale", [None, 0.3])
def test_flash_attention_takes_a_scale(scale):
    q, k, v = _qkv(1, 2, 33, 4, 2, 16)
    got = flash_ops.flash_attention(q, k, v, causal=True, scale=scale)
    s = 16 ** -0.5 if scale is None else scale
    kk, vv = (t.repeat_interleave(2, dim=2) for t in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q * s, kk)
    sc = sc.masked_fill(~torch.ones(33, 33, dtype=torch.bool).tril(),
                        float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vv)
    _close(got, want, 1e-5)
    # and through autograd: the backward takes the same scale
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_ops.flash_attention(*leaves, causal=True, scale=scale).sum() \
        .backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    kp, vp = (t.repeat_interleave(2, dim=2) for t in plain[1:])
    sp = torch.einsum("bqhd,bkhd->bhqk", plain[0] * s, kp).masked_fill(
        ~torch.ones(33, 33, dtype=torch.bool).tril(), float("-inf"))
    torch.einsum("bhqk,bkhd->bqhd", sp.softmax(-1), vp).sum().backward()
    for a, b in zip(leaves, plain):
        _close(a.grad, b.grad, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_decode_attention_takes_a_scale(dtype, scale):
    tdtype = getattr(torch, dtype)
    q, k, v, kvpos, pos = decode_ops.ref.case(7, 2, 40, 4, 2, 16, "fill",
                                              tdtype)
    got = decode_ops.decode_attention(q, k, v, kvpos, pos, scale=scale)
    s = 16 ** -0.5 if scale is None else scale
    # q scaled in its dtype by the scale rounded to it, sums in float32
    qs = (q * torch.tensor(s, dtype=tdtype)).float()
    kk, vv = (t.float().repeat_interleave(2, dim=2) for t in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qs, kk)
    ok = (kvpos >= 0) & (kvpos <= pos[:, None])
    p = sc.masked_fill(~ok[:, None, None], float("-inf")).softmax(-1)
    want = torch.einsum("bhqk,bkhd->bqhd", p.to(tdtype).float(), vv)
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(got.float(), want, tol)


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
class TestHd160OnCard:
    """The bf16 hd-160 forward against the plain version on the same CUDA
    tensors (Zamba2's scale), and the decode kernel at hd 160 and cap 3853.
    Tolerances as ``tests/test_torch_lm_kernels.py``'s bf16 ones: a bf16
    rounding of p and of the output, 2e-2 of the scale."""

    @staticmethod
    def _need_card():
        if not torch.cuda.is_available():
            pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")

    def test_flash_forward_hd160(self):
        self._need_card()
        q, k, v = (t.cuda().bfloat16() for t in _qkv(11, 2, 1024, 32, 32,
                                                      160))
        before = flash_ops.LAUNCHES["flash_attention"]
        got = flash_ops.flash_attention(q, k, v, causal=True,
                                        scale=80 ** -0.5)
        assert flash_ops.LAUNCHES["flash_attention"] == before + 1
        want = flash_ops.ref.flash_attention(q, k, v, causal=True,
                                             scale=80 ** -0.5)
        _close(got.float(), want.float(), 2e-2)

    def test_decode_hd160(self):
        self._need_card()
        args = decode_ops.ref.case(12, 8, 3853, 32, 32, 160, "fill",
                                   torch.bfloat16, "cuda")
        got = decode_ops.decode_attention(*args, scale=80 ** -0.5)
        want = decode_ops.ref.decode_attention(*args, scale=80 ** -0.5)
        _close(got.float(), want.float(), 2e-2)
