"""The port's MoE layer and M-RoPE against the reference package.

``moe_block`` and ``moe_block_local`` (one and two shards, no mesh) take
the same seeded numpy inputs as the reference's, with and without capacity
drops (capacity factors 0.5 and 2.0).  In float32 the routing is exact:
every shard's expert ids, kept entries, buffer slots, source rows and
per-expert counts equal the reference's own dispatch
(``repro.models.moe._local_dispatch``, the routing both of its forms run);
``y`` agrees to 1e-5 and the aux terms to 1e-6, and the input gradient to
1e-5 of its largest.  The port's combine sums each token's k
contributions without a scatter-add, so two calls are bitwise equal.
``apply_mrope`` agrees with the reference's to 1e-6 at the smoke sections
(2, 3, 3) and qwen2-vl's (16, 24, 24) with hd 128.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import export_tree, import_tree, load_jax_params
from repro_torch.models import moe
from repro_torch.models.layers import apply_mrope

D, E, FF, K = 32, 8, 48, 2
B, S = 2, 24
CASES = [(fn, n, cf) for fn, n in (("moe_block", 1), ("moe_block_local", 1),
                                   ("moe_block_local", 2))
         for cf in (0.5, 2.0)]


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D))
    router = rng.standard_normal((D, E)) * 0.3
    wg, wu = (rng.standard_normal((E, D, FF)) * 0.1 for _ in range(2))
    wd = rng.standard_normal((E, FF, D)) * 0.1
    return [a.astype(dtype) for a in (x, router, wg, wu, wd)]


def _port(fn, n, cf, args):
    kw = dict(topk=K, capacity_factor=cf)
    if fn == "moe_block_local":
        kw["n_shards"] = n
    return getattr(moe, fn)(*args, **kw)


def _ref(fn, n, cf, args):
    kw = dict(topk=K, capacity_factor=cf)
    if fn == "moe_block_local":
        kw["n_shards"] = n
    return getattr(jmoe, fn)(*map(jnp.asarray, args), **kw)


class _Routes:
    """Records every routing :func:`moe.route` returns while active."""

    def __enter__(self):
        self.orig, self.seen = moe.route, []

        def recorded(*a, **kw):
            r = self.orig(*a, **kw)
            self.seen.append(r)
            return r
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        moe.route = self.orig


@pytest.mark.parametrize("num_tokens,n_experts,topk,cf", list(
    itertools.product((1, 7, 1000, 8192), (8, 64), (2, 8), (0.5, 1.25))))
def test_moe_capacity(num_tokens, n_experts, topk, cf):
    got = moe.moe_capacity(num_tokens, n_experts, topk, cf)
    assert got == jmoe.moe_capacity(num_tokens, n_experts, topk, cf)
    assert got % 8 == 0 and got >= 8


def test_decode_capacity():
    """decode routes B tokens: olmoe at four requests gets C = 8."""
    cfg = configs.get_config("olmoe-1b-7b")
    assert moe.moe_capacity(4, cfg.n_experts, cfg.topk,
                            cfg.capacity_factor) == 8


@pytest.mark.parametrize("fn,n,cf", CASES)
def test_routing_matches_reference(fn, n, cf):
    args = _inputs()
    with _Routes() as routes:
        _port(fn, n, cf, [torch.from_numpy(a) for a in args])
    r, = routes.seen
    Tl = B * S // n
    C = jmoe.moe_capacity(Tl, E, K, cf)
    xs = args[0].reshape(n, Tl, D)
    for i in range(n):
        _, slot, rows, gate, keep, probs, counts = jmoe._local_dispatch(
            jnp.asarray(xs[i]), jnp.asarray(args[1]), K, C)
        np.testing.assert_array_equal(
            r.expert_idx[i].numpy(), np.asarray(jax.lax.top_k(probs, K)[1]))
        np.testing.assert_array_equal(r.slot[i].numpy(), np.asarray(slot))
        np.testing.assert_array_equal(r.keep[i].numpy(), np.asarray(keep))
        np.testing.assert_array_equal((r.order[i] // K).numpy(),
                                      np.asarray(rows))
        np.testing.assert_array_equal(r.counts[i].numpy(),
                                      np.asarray(counts))
        np.testing.assert_allclose(r.probs[i].numpy(), np.asarray(probs),
                                   rtol=1e-6, atol=1e-7)
    dropped = not bool(r.keep.all())
    assert dropped == (cf == 0.5), "the cases must cover drops and none"


@pytest.mark.parametrize("fn,n,cf", CASES)
def test_output_and_aux_match_reference(fn, n, cf):
    args = _inputs()
    y, aux = _port(fn, n, cf, [torch.from_numpy(a) for a in args])
    jy, jaux = _ref(fn, n, cf, args)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert set(aux) == set(jaux)
    for key in jaux:
        assert aux[key].dtype == torch.float32 and aux[key].dim() == 0
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("fn,n,cf", CASES)
def test_input_grad_matches_reference(fn, n, cf):
    """d(sum y + aux loss)/dx: through the gathers, the expert products,
    the gates and the router probabilities."""
    args = _inputs(seed=1)
    x = torch.from_numpy(args[0]).requires_grad_()
    y, aux = _port(fn, n, cf, [x] + [torch.from_numpy(a) for a in args[1:]])
    (y.sum() + aux["moe_aux_loss"]).backward()

    def f(xx):
        jy, jaux = _ref(fn, n, cf, [xx] + args[1:])
        return jy.sum() + jaux["moe_aux_loss"]
    want = np.asarray(jax.grad(f)(jnp.asarray(args[0])))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_bitwise_equal(dtype):
    args = [torch.from_numpy(a).to(dtype) for a in _inputs(seed=2)]
    y1, a1 = moe.moe_block(*args, topk=K, capacity_factor=0.5)
    y2, a2 = moe.moe_block(*args, topk=K, capacity_factor=0.5)
    assert torch.equal(y1, y2)
    assert all(torch.equal(a1[k], a2[k]) for k in a1)


def test_bf16_matches_reference():
    """bf16 on the same inputs: the router product accumulates in float32
    as the reference's, so routing is the same; y differs by the combine's
    rounding (a sum over k here, a bf16 scatter-add there)."""
    args = _inputs(seed=3)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in args]
    with _Routes() as routes:
        y, aux = moe.moe_block(*bf, topk=K, capacity_factor=2.0)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jy, jaux = jmoe.moe_block(*jargs, topk=K, capacity_factor=2.0)
    _, _, _, _, _, probs, _ = jmoe._local_dispatch(
        jargs[0].reshape(B * S, D), jargs[1], K,
        jmoe.moe_capacity(B * S, E, K, 2.0))
    np.testing.assert_array_equal(routes.seen[0].expert_idx[0].numpy(),
                                  np.asarray(jax.lax.top_k(probs, K)[1]))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(float(aux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), rtol=1e-5)


def test_n_shards_zero_takes_the_context_batch_shards():
    """A11d landed: the mesh comes from the partitioning context (no
    ``mesh=`` argument, no ``NotImplementedError``) and ``n_shards <= 0``
    means the context's batch shards, as in the reference: 1 outside a
    context and on a (1, 1) mesh, where one shard is ``moe_block``
    bitwise.  The expert-parallel form across 8 processes is
    ``tests/test_torch_moe_distributed.py``'s."""
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.partitioning import (current_batch_shards,
                                                 mesh_context)
    args = [torch.from_numpy(a) for a in _inputs()]
    want = moe.moe_block(*args, topk=K)[0]
    y, _ = moe.moe_block_local(*args, topk=K, n_shards=0)
    assert torch.equal(y, want)
    with fake_world():
        with mesh_context(make_mesh((1, 1), ("data", "model"))):
            assert current_batch_shards() == 1
            y, _ = moe.moe_block_local(*args, topk=K, n_shards=0)
    assert torch.equal(y, want)


def test_unaligned_shards_fall_back_to_one():
    args = [torch.from_numpy(a) for a in _inputs()]
    y, aux = moe.moe_block_local(*args, topk=K, n_shards=5)  # 48 % 5 != 0
    want, waux = moe.moe_block_local(*args, topk=K, n_shards=1)
    assert torch.equal(y, want)
    assert float(aux["moe_dropped_frac"]) == float(waux["moe_dropped_frac"])


# ------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(sections, hd, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    # an image grid after a text prefix: t, h and w ids differ
    pos = np.stack([rng.integers(0, 50, (2, 12)) for _ in range(3)],
                   -1).astype(np.int32)
    got = apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(pos), 1e6, sections)
    want = jlayers.apply_mrope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e6,
                               sections)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_apply_mrope_equal_ids_is_rope():
    """One id on all three axes rotates as plain RoPE."""
    from repro_torch.models.layers import apply_rope
    x = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(8, dtype=torch.int32)[None]
    got = apply_mrope(x, pos[..., None].expand(1, 8, 3), 1e4, (2, 3, 3))
    torch.testing.assert_close(got, apply_rope(x, pos, 1e4))


@pytest.mark.parametrize("sections", [(2, 3, 2), (4, 4, 4)])
def test_apply_mrope_rejects_bad_sections(sections):
    x = torch.zeros(1, 4, 2, 16)
    pos = torch.zeros(1, 4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="must sum to 8"):
        apply_mrope(x, pos, 1e6, sections)
    with pytest.raises(ValueError, match="must sum to 8"):
        jlayers.apply_mrope(jnp.zeros((1, 4, 2, 16)),
                            jnp.zeros((1, 4, 3), jnp.int32), 1e6, sections)


# ------------------------------------------------------- the MoE block
@functools.lru_cache(maxsize=None)
def _olmoe(dtype="float32"):
    jc = dataclasses.replace(jconfigs.smoke_config("olmoe-1b-7b"),
                             dtype=dtype)
    tc = dataclasses.replace(configs.smoke_config("olmoe-1b-7b"),
                             dtype=dtype)
    params = jmodels.init_params(jc, jax.random.PRNGKey(0))
    return jc, params, tc, load_jax_params(
        tc, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("local", [True, False])
def test_moe_block_matches_reference(local):
    """One attention + MoE block, both dispatch forms (the config's
    ``moe_local_dispatch``), float32 at 1e-4."""
    jc, params, tc, model = _olmoe()
    jc = dataclasses.replace(jc, moe_local_dispatch=local)
    tc = dataclasses.replace(tc, moe_local_dispatch=local)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(S, dtype=np.int32)[None], (B, S)))
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])
    jout, jkv, jaux = jblocks.apply_moe_block(
        p0, jc, jnp.asarray(h), jnp.asarray(pos), return_kv=True)
    from repro_torch.models.blocks import apply_moe_block
    with torch.no_grad():
        tout, tkv, taux = apply_moe_block(
            model.blocks[0], tc, torch.from_numpy(h), torch.from_numpy(pos),
            return_kv=True)
    want = np.asarray(jout) - h
    np.testing.assert_allclose((tout.numpy() - h), want, rtol=1e-4,
                               atol=1e-4 * min(1.0, np.abs(want).max()))
    np.testing.assert_allclose(tkv[1].numpy(), np.asarray(jkv[1]),
                               rtol=1e-4, atol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_expert_stack_round_trip():
    """Expert stacks (L, E, d, ff) out to the reference's layout and back,
    bitwise; the layout is the reference's own tree."""
    jc, params, tc, model = _olmoe()
    named = dict(model.named_parameters())
    tree = export_tree(tc, named)
    ref = jax.tree.map(np.asarray, params)
    assert tree["blocks"]["moe"]["w_gate"].shape == (
        tc.n_layers, tc.n_experts, tc.d_model, tc.d_ff)
    jax.tree.map(np.testing.assert_array_equal, tree, ref)
    fresh = load_jax_params(tc, ref, device="cpu")
    twice = {n: torch.zeros_like(t) for n, t in named.items()}
    import_tree(tc, export_tree(tc, dict(fresh.named_parameters())), twice)
    for name, t in named.items():
        assert torch.equal(twice[name], t), name
