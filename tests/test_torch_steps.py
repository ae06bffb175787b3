"""``runtime.make_decode_step`` off the card: CPU tensors, a CPU mesh's
DTensors and the dry run take ``models.decode_step`` itself, bit for bit,
and ``GRAPHS["eager"]`` counts them; the key of a step's graph separates
batch sizes and cache capacities.  The graphs themselves run on the card:
``tests/test_torch_steps_card.py``."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.runtime import steps

ZYPHRA = dict(n_layers=6, d_model=64, vocab=256, ssm_state=16,
              ssm_headdim=16, ssm_chunk=16, n_heads=4, n_kv_heads=4,
              head_dim=32, d_ff=96, hybrid_layer_ids=(2, 4, 5),
              num_mem_blocks=2, adapter_rank=4)


def _cfg(name):
    if name == "zamba2-2.7b-zyphra":
        return dataclasses.replace(get_config(name), **ZYPHRA,
                                   dtype="float32")
    return dataclasses.replace(smoke_config(name), dtype="float32")


def _served(cfg, B=3, S=12, new=6, seed=0):
    """A model, a prompt batch and its prefill's logits and cache."""
    model = init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    if cfg.family == "vlm":
        feed = {"embeds": torch.randn((B, S, cfg.d_model), generator=g),
                "positions": torch.arange(S, dtype=torch.int32)[
                    None, :, None].expand(B, S, 3)}
    else:
        feed = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                        dtype=torch.int32)}
    logits, cache = prefill(model, cfg, feed, capacity=S + new)
    return model, logits, cache


def _feed(cfg, tok, B):
    if cfg.family == "vlm":
        return {"embeds": torch.zeros((B, 1, cfg.d_model))}
    return {"tokens": tok}


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "zamba2-2.7b",
                                  "zamba2-2.7b-zyphra", "qwen2-vl-72b"])
def test_cpu_step_is_decode_step(name):
    """Several greedy steps through the step and through ``decode_step``
    on a copy of the cache: logits and caches equal bit for bit, every
    call eager, nothing captured."""
    cfg = _cfg(name)
    B, S, new = 3, 12, 6
    model, logits, cache = _served(cfg, B, S, new)
    mine = {k: v.clone() for k, v in cache.items()}
    step = steps.make_decode_step(cfg)
    before = dict(steps.GRAPHS)
    tok = want_tok = logits[:, -1].argmax(-1)
    for j in range(new):
        pos = torch.full((B,), S + j, dtype=torch.int32)
        got, mine = step(model, _feed(cfg, tok, B), mine, pos)
        want, cache = decode_step(model, cfg, _feed(cfg, want_tok, B),
                                  cache, pos)
        assert torch.equal(got, want), j
        tok, want_tok = got[:, -1].argmax(-1), want[:, -1].argmax(-1)
    assert mine.keys() == cache.keys()
    for k in cache:
        assert torch.equal(mine[k], cache[k]), k
    assert steps.GRAPHS["eager"] - before["eager"] == new
    assert {k: steps.GRAPHS[k] - before[k]
            for k in ("capture", "replay", "adopt")} == dict.fromkeys(
                ("capture", "replay", "adopt"), 0)


def _mesh_call(cfg):
    """One step of a model whose parameters are DTensors on a one-rank CPU
    mesh; returns its logits and ``decode_step``'s on plain tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.device import process_world
    from repro_torch.launch.partitioning import default_rules, mesh_context
    from repro_torch.launch.train import place_params
    model, logits, cache = _served(cfg)
    pos = torch.full((3,), 12, dtype=torch.int32)
    tok = logits[:, -1].argmax(-1)
    want, _ = decode_step(model, cfg, {"tokens": tok},
                          {k: v.clone() for k, v in cache.items()}, pos)
    with process_world("cpu"):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = default_rules(mesh)
        place_params(model, cfg, mesh, rules)

        def put(t):
            return distribute_tensor(t, mesh, [Replicate(), Replicate()])
        with mesh_context(mesh, rules):
            got, _ = steps.make_decode_step(cfg)(
                model, {"tokens": put(tok)},
                {k: put(v) for k, v in cache.items()}, put(pos))
            got = got.full_tensor()
    return got, want


def _dry_run_call(cfg):
    """One step on fake tensors inside the dry run, where the kernels'
    operators stand in for the launches.  Returns the logits' shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import dryrun
    from repro_torch.models import Model
    from repro_torch.models.model import cache_shapes
    with FakeTensorMode(), dryrun.dry_run():
        model = Model(cfg, None, torch.device("cpu"))
        cache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt)
                 in cache_shapes(cfg, 2, 16).items()}
        got, _ = steps.make_decode_step(cfg)(
            model, {"tokens": torch.zeros((2,), dtype=torch.int32)}, cache,
            torch.full((2,), 3, dtype=torch.int32))
        return tuple(got.shape)


@pytest.mark.parametrize("where", ["cpu-mesh", "dry-run"])
def test_mesh_and_dry_run_take_the_eager_path(where):
    cfg = _cfg("olmoe-1b-7b")
    before = dict(steps.GRAPHS)
    if where == "cpu-mesh":
        got, want = _mesh_call(cfg)
        assert torch.equal(got, want)
    else:
        assert _dry_run_call(cfg) == (2, 1, cfg.vocab)
    assert steps.GRAPHS["eager"] - before["eager"] == 1
    assert steps.GRAPHS["capture"] == before["capture"]


@pytest.mark.parametrize("change,same", [
    (dict(B=4), False),            # another batch size
    (dict(cap=40), False),         # another capacity
    (dict(seed=5), True),          # another batch of the same shape
])
def test_key_separates_batch_sizes_and_caps(change, same):
    cfg = _cfg("olmoe-1b-7b")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    from repro_torch.models import init_cache

    def key(B=3, cap=32, seed=0):
        toks = torch.randint(0, cfg.vocab, (B,), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(seed))
        return steps._key(model, {"tokens": toks},
                          init_cache(cfg, B, cap, device="cpu"),
                          torch.full((B,), 7, dtype=torch.int32))
    assert (key(**change) == key()) is same
