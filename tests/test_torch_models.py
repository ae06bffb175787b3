"""The port's model zoo (serving path) against the reference package.

The reference's weights, drawn with ``jax.random`` and carried over as numpy
arrays by ``load_jax_params``, go through both packages with the same
seeded tokens: prefill's last-token logits, every cache entry, and four
decode steps, each step fed the same token, must agree — in float32 within
1e-4, in bfloat16 within 3e-2 (``tests/test_models.py``'s own tolerance).
In float32 the absolute part is 1e-4 of each tensor's largest value when
that is below 1: at smoke init the SSM states and the blocks' increments
are ~1e-3, and an absolute 1e-4 would not see a 1 % error in them.
On the CPU the port's prefill runs the plain versions of its kernels
(``tests/test_torch_lm_kernels.py`` holds those against the Pallas
kernels).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import blocks as jblocks
from repro.runtime import make_decode_step as j_make_decode_step
from repro.runtime import make_prefill_step as j_make_prefill_step
from repro_torch import configs
from repro_torch.models import (cache_shapes, decode_step, init_cache,
                                init_params, load_jax_params, prefill)
from repro_torch.models.model import _forward_seq, _head_logits
from repro_torch.runtime import make_decode_step, make_prefill_step

SERVED = ["zamba2-2.7b", "mamba2-780m", "llama3-8b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
B, S, CAP = 2, 40, 48  # S = 40: two and a half smoke SSD chunks of 16


def _cfgs(arch, dtype, **over):
    jc = dataclasses.replace(jconfigs.smoke_config(arch), dtype=dtype, **over)
    tc = dataclasses.replace(configs.smoke_config(arch), dtype=dtype, **over)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype, window=None):
    """(jax cfg, jax params, port cfg, port model) with the same weights."""
    jc, tc = _cfgs(arch, dtype, sliding_window=window)
    params = jmodels.init_params(jc, jax.random.PRNGKey(0))
    model = load_jax_params(tc, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jc, params, tc, model


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    want = _f32(want)
    if tol is TOL["float32"]:
        scale = min(1.0, float(np.abs(want).max()))
        tol = dict(rtol=tol["rtol"], atol=tol["atol"] * scale)
    np.testing.assert_allclose(_f32(got), want, err_msg=what, **tol)


def _close_cache(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), (what, k)
        if k == "kv_positions":
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), what)
        else:
            _close(got[k], want[k], tol, f"{what}: cache[{k}]")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,window", [(a, None) for a in SERVED]
                         + [("zamba2-2.7b", 16)])
def test_serving_matches_reference(arch, window, dtype):
    """prefill logits + cache, then 4 decode steps fed the same tokens."""
    jc, params, tc, model = _pair(arch, dtype, window)
    tol = TOL[dtype]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    j_pre = jax.jit(j_make_prefill_step(jc, capacity=CAP))
    j_dec = jax.jit(j_make_decode_step(jc))
    jl, jcache = j_pre(params, {"tokens": jnp.asarray(toks)})
    tl, tcache = make_prefill_step(tc, capacity=CAP)(
        model, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, 1, jc.vocab) and tl.dtype == torch.float32
    _close(tl, jl, tol, "prefill logits")
    _close_cache(tcache, jcache, tol, "prefill")
    step = make_decode_step(tc)
    for t in range(4):
        tok = rng.integers(0, jc.vocab, (B,)).astype(np.int32)
        pos = np.full((B,), S + t, np.int32)
        jl, jcache = j_dec(params, {"tokens": jnp.asarray(tok)}, jcache,
                           jnp.asarray(pos))
        tl, tcache = step(model, {"tokens": torch.from_numpy(tok)}, tcache,
                          torch.from_numpy(pos))
        _close(tl, jl, tol, f"decode step {t} logits")
        _close_cache(tcache, jcache, tol, f"decode step {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_decode_after_prefill_matches_forward(arch, dtype):
    """decode(pos=S) after prefill(S) == a forward pass over S+1 tokens, in
    the port and against the reference's forward pass."""
    jc, params, tc, model = _pair(arch, dtype)
    tol = TOL[dtype]
    seq = 32
    toks = np.random.default_rng(2).integers(
        0, jc.vocab, (1, seq + 1)).astype(np.int32)
    tt = torch.from_numpy(toks)
    h = model.embed[tt.long()].to(getattr(torch, dtype))
    pos = torch.arange(seq + 1, dtype=torch.int32)[None]
    with torch.no_grad():
        h, _, _ = _forward_seq(model, tc, h, pos, collect_cache=False)
        full = _head_logits(model, tc, h)
    _, cache = prefill(model, tc, {"tokens": tt[:, :seq]}, capacity=seq + 4)
    dec, _ = decode_step(model, tc, {"tokens": tt[:, seq]}, cache,
                         torch.full((1,), seq, dtype=torch.int32))
    _close(dec[0, 0], full[0, seq], TOL["bfloat16"], "decode vs forward")

    from repro.models.model import (_default_positions, _embed_inputs,
                                    _forward_seq as j_forward_seq,
                                    _head_logits as j_head_logits)
    jb = {"tokens": jnp.asarray(toks)}
    jh = _embed_inputs(params, jc, jb)
    jh, _, _ = j_forward_seq(params, jc, jh,
                             _default_positions(jc, 1, seq + 1),
                             collect_cache=False)
    _close(full, j_head_logits(params, jc, jh), tol, "forward vs reference")


@pytest.mark.parametrize("arch", SERVED)
def test_blocks_match_reference(arch):
    """One block of each kind the model holds, in float32 at 1e-4."""
    jc, params, tc, model = _pair(arch, "float32")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    th, tpos = torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(pos))
    if jc.family == "dense":
        p0 = jax.tree.map(lambda a: a[0], params["blocks"])
        jout, jkv = jblocks.apply_dense_block(p0, jc, jnp.asarray(h),
                                              jnp.asarray(pos),
                                              return_kv=True)
        with torch.no_grad():
            tout, tkv = model.blocks[0](th, tpos, return_kv=True)
        _close(tout - th, jout - h, TOL["float32"], "dense block increment")
        _close(tkv[0], jkv[0], TOL["float32"], "dense block k")
        return
    p0 = jax.tree.map(lambda a: a[0, 0] if jc.family == "hybrid" else a[0],
                      params["blocks"])
    jout, jst, jtail = jblocks.apply_mamba2_block(p0, jc, jnp.asarray(h))
    with torch.no_grad():
        tout, tst, ttail = model.blocks[0](th)
    _close(tout - th, jout - h, TOL["float32"], "mamba2 block increment")
    _close(tst, jst, TOL["float32"], "mamba2 final state")
    _close(ttail, jtail, TOL["float32"], "mamba2 conv tail")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    port, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.smoke_config(arch))
    assert port.params_count() == ref.params_count()


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_full_config_param_count_matches_reference(arch):
    """The full-width model holds exactly the reference's parameters."""
    cfg = configs.get_config(arch)
    model = init_params(cfg, None, device="meta")
    shapes = jax.tree.leaves(jmodels.param_shapes(jconfigs.get_config(arch)))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(s.shape)) for s in shapes)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_shapes_match_reference(arch):
    cfg = configs.get_config(arch)
    for window in (None, 1024):
        tc = dataclasses.replace(cfg, sliding_window=window)
        jc = dataclasses.replace(jconfigs.get_config(arch),
                                 sliding_window=window)
        want = jmodels.cache_shapes(jc, 4, 2080)
        got = cache_shapes(tc, 4, 2080)
        assert set(got) == set(want)
        for k, (shape, dt) in got.items():
            assert shape == want[k].shape, k
            assert str(dt).split(".")[-1] == want[k].dtype.name, k


def test_init_cache_and_init_kinds():
    cfg = configs.smoke_config("zamba2-2.7b")
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert (cache["kv_positions"] == -1).all()
    assert all(not v.any() for k, v in cache.items() if k != "kv_positions")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mix = model.blocks[0].mamba
    H = cfg.ssm_heads
    torch.testing.assert_close(mix.A_log.data,
                               torch.log(torch.linspace(1.0, 16.0, H)))
    assert (mix.ln == 1).all() and (mix.D == 1).all()
    assert not mix.conv_b.any()
    dt = torch.nn.functional.softplus(mix.dt_bias.data)
    assert ((dt > 0.999e-3) & (dt < 1.001e-1)).all()
    assert abs(float(model.embed.detach().std()) - 0.02) < 2e-3
    # the same generator seed gives the same weights
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


NEW_FAMILIES = ["olmoe-1b-7b", "qwen2-vl-72b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_moe_vlm_audio_families_build(arch):
    """The moe, vlm and audio families build from a generator, with the
    reference's parameter tree and serving cache (none for audio)."""
    cfg = configs.smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    from repro_torch.models import tree_shapes
    got = tree_shapes(cfg, dict(model.named_parameters()))
    want = jax.tree.map(lambda s: tuple(s.shape), jmodels.param_shapes(
        jconfigs.smoke_config(arch)))
    assert got == want
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert set(cache) == set(jmodels.cache_shapes(
        jconfigs.smoke_config(arch), 2, 8))
    assert bool(cache) == (cfg.family != "audio")


def _grid_positions(Bsz, n, w=8):
    """3-axis M-RoPE ids of an image of ``n`` patches, ``w`` to a row: the
    temporal id fixed, height and width varying."""
    i = np.arange(n)
    pos = np.stack([np.zeros(n), i // w, i % w], -1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos, (Bsz, n, 3)))


def _prompt(jc, rng, feed):
    """(reference batch, port batch) of one prompt: tokens, or embeds with
    a 3-axis image grid."""
    if feed == "tokens":
        toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {
            "tokens": torch.from_numpy(toks)}
    e = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = _grid_positions(B, S)
    return ({"embeds": jnp.asarray(e), "positions": jnp.asarray(pos)},
            {"embeds": torch.from_numpy(e),
             "positions": torch.from_numpy(pos)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,feed", [("olmoe-1b-7b", "tokens"),
                                       ("qwen2-vl-72b", "tokens"),
                                       ("qwen2-vl-72b", "embeds")])
def test_moe_vlm_serving_matches_reference(arch, feed, dtype):
    """olmoe (MoE with the config's shard-local dispatch) and qwen2-vl
    (M-RoPE; tokens, or embeds on an image grid with embeds fed at decode):
    prefill logits + cache, then 4 decode steps."""
    jc, params, tc, model = _pair(arch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(6)
    jb, tb = _prompt(jc, rng, feed)
    jl, jcache = jax.jit(j_make_prefill_step(jc, capacity=CAP))(params, jb)
    tl, tcache = make_prefill_step(tc, capacity=CAP)(model, tb)
    _close(tl, jl, tol, "prefill logits")
    _close_cache(tcache, jcache, tol, "prefill")
    j_dec, step = jax.jit(j_make_decode_step(jc)), make_decode_step(tc)
    for t in range(4):
        if feed == "tokens":
            x = rng.integers(0, jc.vocab, (B,)).astype(np.int32)
        else:
            x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        jd, td = {feed: jnp.asarray(x)}, {feed: torch.from_numpy(x)}
        pos = np.full((B,), S + t, np.int32)
        jl, jcache = j_dec(params, jd, jcache, jnp.asarray(pos))
        tl, tcache = step(model, td, tcache, torch.from_numpy(pos))
        _close(tl, jl, tol, f"decode step {t} logits")
        _close_cache(tcache, jcache, tol, f"decode step {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_step_matches_reference(dtype):
    """hubert (encoder-only, non-causal): every frame's logits through
    ``step_fn_for(cfg, "encode")``; prefill and decode raise on both
    sides."""
    from repro.runtime import step_fn_for as j_step_fn_for
    from repro_torch.runtime import step_fn_for
    jc, params, tc, model = _pair("hubert-xlarge", dtype)
    e = np.random.default_rng(7).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    want = jax.jit(j_step_fn_for(jc, "encode"))(params,
                                                {"embeds": jnp.asarray(e)})
    got = step_fn_for(tc, "encode")(model, {"embeds": torch.from_numpy(e)})
    assert got.shape == (B, S, jc.vocab) and got.dtype == torch.float32
    assert not got.requires_grad
    _close(got, want, TOL[dtype], "encode logits")
    with pytest.raises(ValueError, match="encoder-only"):
        jmodels.prefill(params, jc, {"embeds": jnp.asarray(e)})
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(model, tc, {"embeds": torch.from_numpy(e)})
    with pytest.raises(ValueError, match="encoder-only"):
        jmodels.decode_step(params, jc, {"embeds": jnp.asarray(e[:, :1])},
                            {}, jnp.zeros((B,), jnp.int32))
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(model, tc, {"embeds": torch.from_numpy(e[:, :1])}, {},
                    torch.zeros((B,), dtype=torch.int32))


def test_load_rejects_foreign_trees():
    jc, params, tc, _ = _pair("mamba2-780m", "float32")
    tree = jax.tree.map(np.asarray, params)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no counterpart"):
        load_jax_params(tc, tree, device="cpu")
    bad = dataclasses.replace(tc, d_model=tc.d_model * 2)
    with pytest.raises(ValueError):
        load_jax_params(bad, jax.tree.map(np.asarray, params), device="cpu")

