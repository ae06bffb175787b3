"""The port's training path against the reference package, on the CPU.

The reference's weights, drawn with ``jax.random`` and carried over by
``load_jax_params``, and the same ``host_batch`` tokens go through the
reference's ``forward_train`` under ``jax.value_and_grad`` and the port's
``forward_train`` under autograd (on the CPU the port's attention and SSD
take their plain forward and backward versions).  In float32 the loss
agrees to 1e-5 relative and every gradient leaf to 1e-4 of that leaf's
largest |reference grad|; in bfloat16 the loss agrees to 2e-2 and every
gradient leaf has a cosine similarity of at least 0.99 with the
reference's (the two frameworks round bf16 at different places).  AdamW fed
the reference's own gradients agrees to 1e-6, and three ``train_step``s
agree with the reference's ``make_train_step``.
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
from repro.data import host_batch as j_host_batch
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.runtime import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.data import host_batch
from repro_torch.models import (decayed, export_tree, forward_train,
                                load_jax_params)
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime import make_train_step, step_fn_for

B, S = 2, 40  # S = 40: two and a half smoke SSD chunks of 16


def _cfgs(arch, dtype, **over):
    jc = dataclasses.replace(jconfigs.smoke_config(arch), dtype=dtype, **over)
    tc = dataclasses.replace(configs.smoke_config(arch), dtype=dtype, **over)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _params(arch, dtype, **over):
    jc, tc = _cfgs(arch, dtype, **over)
    return jc, jmodels.init_params(jc, jax.random.PRNGKey(0)), tc


def _port_model(tc, params):
    return load_jax_params(tc, jax.tree.map(np.asarray, params),
                           device="cpu")


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_grads(arch, dtype, **over):
    """(jax cfg, params, port cfg, loss, grads as numpy float32 tree)."""
    jc, params, tc = _params(arch, dtype, **over)
    batch = {k: jnp.asarray(v) for k, v in j_host_batch(jc, S, B, 3).items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jmodels.forward_train(p, jc, batch), has_aux=True)(params)
    f32 = jax.tree.map(lambda g: np.asarray(jnp.asarray(g, jnp.float32)),
                       grads)
    return jc, params, tc, float(loss), f32


def _port_grads(tc, params):
    model = _port_model(tc, params)
    named = dict(model.named_parameters())
    loss, metrics = forward_train(model, tc,
                                  _torch_batch(host_batch(tc, S, B, 3)))
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, metrics, export_tree(tc, dict(zip(named, grads)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def _check_close(got, want, atol):
    """Two trees leaf by leaf (paired by path) within ``atol``."""
    got = dict(_leaves(got))
    for name, w in _leaves(want):
        np.testing.assert_allclose(got.pop(name), w, rtol=0, atol=atol,
                                   err_msg=name)
    assert not got, sorted(got)


def _check_grads(got, want, dtype):
    got = dict(_leaves(got))
    for name, w in _leaves(want):
        g = got.pop(name)
        assert g.shape == w.shape, name
        if dtype == "float32":
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
        else:
            cos = float((g * w).sum() / np.sqrt((g * g).sum() * (w * w).sum()))
            assert cos >= 0.99, (name, cos)
    assert not got, sorted(got)


class TestForwardTrain:
    @pytest.mark.parametrize("arch,dtype", [
        ("zamba2-2.7b", "float32"), ("mamba2-780m", "float32"),
        ("qwen3-1.7b", "float32"), ("llama3-8b", "float32"),
        ("zamba2-2.7b", "bfloat16"), ("mamba2-780m", "bfloat16"),
        ("llama3-8b", "bfloat16"),
    ])
    def test_loss_and_grads_match_reference(self, arch, dtype):
        _, params, tc, jloss, jgrads = _reference_grads(arch, dtype)
        loss, metrics, grads = _port_grads(tc, params)
        assert float(metrics["ce_loss"]) == float(loss)
        rtol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(float(loss), jloss, rtol=rtol)
        _check_grads(grads, jgrads, dtype)

    def test_remat_and_logits_chunk(self):
        """``remat="full"`` (the reference's ``jax.checkpoint`` around each
        super-layer, here ``torch.utils.checkpoint``) and the chunked head
        (S = 40 over chunks of 16: the reference leaves the 8-token tail
        out, and so does the port)."""
        over = dict(remat="full", logits_chunk=16)
        _, params, tc, jloss, jgrads = _reference_grads("zamba2-2.7b",
                                                        "float32", **over)
        loss, _, grads = _port_grads(tc, params)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        _check_grads(grads, jgrads, "float32")
        # the port's remat recomputes what it dropped: the same gradients
        plain = dataclasses.replace(tc, remat="none")
        _, _, again = _port_grads(plain, params)
        _check_close(grads, again, atol=0)

    def test_waiting_families_raise(self):
        tc = configs.smoke_config("olmoe-1b-7b")
        with pytest.raises(NotImplementedError, match="A11a"):
            forward_train(None, tc, {})
        with pytest.raises(NotImplementedError, match="A11a"):
            step_fn_for(tc, "encode")


class TestAdamW:
    # the smoke grads' norm is ~5: clipping inactive at 1e-2, active at 1
    @pytest.mark.parametrize("grad_scale", [1e-2, 1.0])
    def test_matches_reference_on_its_grads(self, grad_scale):
        jc, params, tc, _, jgrads = _reference_grads("zamba2-2.7b",
                                                     "float32")
        jgrads = jax.tree.map(lambda g: jnp.asarray(g * grad_scale), jgrads)
        jopt = j_adamw_init(params)
        model = _port_model(tc, params)
        named = dict(model.named_parameters())
        opt = adamw_init(named)
        grads = {n: torch.from_numpy(np.array(np.asarray(
            _tree_get(jgrads, n, tc)))) for n in named}
        for lr in (1e-3, 2e-3):  # two steps: the moments carry over
            jparams, jopt, jstats = j_adamw_update(jgrads, jopt, params,
                                                   lr=lr)
            params = jparams
            stats = adamw_update(grads, opt, named, lr=lr,
                                 decay=decayed(tc, named))
            np.testing.assert_allclose(float(stats["grad_norm"]),
                                       float(jstats["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(float(stats["clip_scale"]),
                                       float(jstats["clip_scale"]),
                                       rtol=1e-6)
            assert (float(stats["clip_scale"]) < 1) == (grad_scale == 1)
            for tree, want in ((named, jparams), (opt["m"], jopt["m"]),
                               (opt["v"], jopt["v"])):
                _check_close(export_tree(tc, tree), want, atol=1e-6)
            assert int(opt["count"]) == int(jopt["count"])

    def test_cosine_schedule(self):
        kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50)
        ours, ref = cosine_schedule(**kw), j_cosine_schedule(**kw)
        for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
            np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))),
                                       rtol=1e-6, err_msg=str(step))


def _tree_get(tree, name, cfg):
    """The reference-layout leaf of the port's parameter ``name``."""
    from repro_torch.models.model import _ref_path
    path, idx = _ref_path(cfg, name)
    for key in path:
        tree = tree[key]
    return np.asarray(tree)[idx]


class TestTrainStep:
    def test_three_steps_match_reference(self):
        kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
        jc, params, tc = _params("llama3-8b", "float32")
        jstep = jax.jit(j_make_train_step(jc, **kw))
        step_fn = make_train_step(tc, **kw)
        model = _port_model(tc, params)
        named = dict(model.named_parameters())
        opt, jopt = adamw_init(named), j_adamw_init(params)
        moved = 0.0  # the summed step sizes: AdamW moves an element by
        for step in range(1, 4):  # at most ~lr a step, whatever its grad
            batch = j_host_batch(jc, S, B, step)
            params, jopt, jm = jstep(
                params, jopt, {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.int32(step))
            m = step_fn(model, opt, _torch_batch(host_batch(tc, S, B, step)),
                        step)
            assert set(m) == {"loss", "ce_loss", "lr", "grad_norm",
                              "clip_scale"}
            for key in m:
                np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                           rtol=1e-5, err_msg=key)
            moved += m["lr"]
        # an element whose gradient is ~0 takes a step of either sign from
        # a tiny difference in it: hold the parameters to 1e-3 of the
        # largest distance the steps could move them
        _check_close(export_tree(tc, named), params, atol=1e-3 * moved)
