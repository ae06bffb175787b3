"""``runtime.make_decode_step``'s CUDA graphs on the card, at small sizes
in bf16: every family's graphed step against ``models.decode_step`` run
eagerly on a copy of the same cache over 20 greedy steps; a second batch
of a shape adopted into its graph and a second shape captured once;
logits that outlive the next step; two batches of one shape interleaved;
the kernels' launch counts moved by each replay; and the memory handed
back when the step goes.

The graph replays the eager step's kernels in its order on the same
buffers' contents, so logits and caches are held equal bit for bit."""

import dataclasses
import gc

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.runtime import steps

ZYPHRA = dict(n_layers=6, d_model=64, vocab=256, ssm_state=16,
              ssm_headdim=16, ssm_chunk=16, n_heads=4, n_kv_heads=4,
              head_dim=32, d_ff=96, hybrid_layer_ids=(2, 4, 5),
              num_mem_blocks=2, adapter_rank=4)
FAMILIES = ["olmoe-1b-7b", "zamba2-2.7b-zyphra", "zamba2-2.7b",
            "mamba2-780m", "qwen3-1.7b", "qwen2-vl-72b"]
TWO = ["olmoe-1b-7b", "zamba2-2.7b-zyphra"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs and the decode kernel need a CUDA card")


def _cfg(name):
    if name == "zamba2-2.7b-zyphra":
        return dataclasses.replace(get_config(name), **ZYPHRA)
    return smoke_config(name)


def _model(cfg, seed=0):
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")


def _prefill(model, cfg, B, S, cap, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.family == "vlm":
        feed = {"embeds": torch.randn((B, S, cfg.d_model), generator=g,
                                      device="cuda"),
                "positions": torch.arange(S, dtype=torch.int32,
                                          device="cuda")[
                    None, :, None].expand(B, S, 3)}
    else:
        feed = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                        dtype=torch.int32, device="cuda")}
    return prefill(model, cfg, feed, capacity=cap)


def _feed(cfg, tok):
    if cfg.family == "vlm":
        return {"embeds": torch.zeros((tok.shape[0], 1, cfg.d_model),
                                      device="cuda")}
    return {"tokens": tok}


def _pos(B, p):
    return torch.full((B,), p, dtype=torch.int32, device="cuda")


def _copy(cache):
    return {k: v.clone() for k, v in cache.items()}


def _attention_uses(cfg):
    if cfg.family == "moe":
        return cfg.n_layers
    return len(cfg.hybrid_layer_ids)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_graph_matches_eager_over_20_steps(name):
    _need_card()
    cfg = _cfg(name)
    model = _model(cfg)
    B, S, n = 4, 40, 20
    logits, cache = _prefill(model, cfg, B, S, S + n)
    mine = _copy(cache)
    step = steps.make_decode_step(cfg)
    before = dict(steps.GRAPHS)
    tok = logits[:, -1].argmax(-1)
    for j in range(n):
        got, mine = step(model, _feed(cfg, tok), mine, _pos(B, S + j))
        want, cache = decode_step(model, cfg, _feed(cfg, tok), cache,
                                  _pos(B, S + j))
        assert torch.equal(got, want), (name, j)
        tok = want[:, -1].argmax(-1)
    for k in cache:
        assert torch.equal(mine[k], cache[k]), (name, k)
    moved = {k: steps.GRAPHS[k] - before[k] for k in before}
    assert moved == {"capture": 1, "replay": n - 1, "adopt": 0, "eager": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", TWO)
def test_a_second_batch_is_adopted_and_a_second_shape_captured(name):
    _need_card()
    cfg = _cfg(name)
    model = _model(cfg)
    step = steps.make_decode_step(cfg)
    before = dict(steps.GRAPHS)

    def serve(B, S, seed, n=3):
        logits, cache = _prefill(model, cfg, B, S, S + n, seed)
        want_cache = _copy(cache)
        tok = logits[:, -1].argmax(-1)
        for j in range(n):
            got, cache = step(model, _feed(cfg, tok), cache, _pos(B, S + j))
            want, want_cache = decode_step(model, cfg, _feed(cfg, tok),
                                           want_cache, _pos(B, S + j))
            assert torch.equal(got, want), (B, S, seed, j)
            tok = want[:, -1].argmax(-1)

    serve(4, 40, 1)
    serve(4, 40, 2)          # the same shape: adopted, not captured
    moved = {k: steps.GRAPHS[k] - before[k] for k in before}
    assert moved == {"capture": 1, "replay": 5, "adopt": 1, "eager": 0}
    serve(2, 24, 3)          # another shape: captured once
    moved = {k: steps.GRAPHS[k] - before[k] for k in before}
    assert moved == {"capture": 2, "replay": 7, "adopt": 1, "eager": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", TWO)
def test_logits_outlive_the_next_step(name):
    _need_card()
    cfg = _cfg(name)
    model = _model(cfg)
    B, S = 4, 40
    logits, cache = _prefill(model, cfg, B, S, S + 4)
    step = steps.make_decode_step(cfg)
    tok = logits[:, -1].argmax(-1)
    outs = []
    for j in range(4):
        out, cache = step(model, _feed(cfg, tok), cache, _pos(B, S + j))
        outs.append((out, out.clone()))
        tok = out[:, -1].argmax(-1)
    for j, (out, kept) in enumerate(outs):
        assert torch.equal(out, kept), j


@pytest.mark.cuda
@pytest.mark.parametrize("name", TWO)
def test_two_batches_of_one_shape_interleaved(name):
    """Steps of two live batches of one shape in turn: each hand-over
    copies the other batch's state in, and the batch handed over keeps its
    own, so both match the eager step."""
    _need_card()
    cfg = _cfg(name)
    model = _model(cfg)
    B, S, n = 4, 40, 4
    step = steps.make_decode_step(cfg)
    live = []
    for seed in (1, 2):
        logits, cache = _prefill(model, cfg, B, S, S + n, seed)
        live.append([cache, _copy(cache), logits[:, -1].argmax(-1)])
    for j in range(n):
        for b in live:
            cache, want_cache, tok = b
            got, b[0] = step(model, _feed(cfg, tok), cache, _pos(B, S + j))
            want, b[1] = decode_step(model, cfg, _feed(cfg, tok), want_cache,
                                     _pos(B, S + j))
            assert torch.equal(got, want), j
            b[2] = want[:, -1].argmax(-1)
    for cache, want_cache, _ in live:
        for k in cache:
            assert torch.equal(cache[k], want_cache[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", TWO)
def test_each_replay_counts_its_decode_launches(name):
    _need_card()
    cfg = _cfg(name)
    model = _model(cfg)
    B, S, n = 4, 40, 5
    logits, cache = _prefill(model, cfg, B, S, S + n)
    step = steps.make_decode_step(cfg)
    tok = logits[:, -1].argmax(-1)
    for j in range(n):
        was = decode_ops.LAUNCHES["decode_attention"]
        out, cache = step(model, _feed(cfg, tok), cache, _pos(B, S + j))
        assert decode_ops.LAUNCHES["decode_attention"] - was \
            == _attention_uses(cfg), j
        tok = out[:, -1].argmax(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TWO)
def test_dropping_the_step_frees_its_graphs(name):
    _need_card()
    cfg = _cfg(name)
    model = _model(cfg)
    B, S = 4, 40
    logits, cache = _prefill(model, cfg, B, S, S + 6)
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    step = steps.make_decode_step(cfg)
    for j, (b, s) in enumerate(((B, S), (B, S), (2, 24))):
        c = cache if b == B else _prefill(model, cfg, b, s, s + 6)[1]
        out, c = step(model, _feed(cfg, tok[:b]), c, _pos(b, s + j))
    del step, out, c
    gc.collect()
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - held) <= 64 << 20
