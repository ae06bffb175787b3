"""The traffic mixes: the same inputs for the same seed, the same sizes
for every seed."""

import json
from pathlib import Path

import torch

from perfbench.harness import context
from perfbench.kinds import serve_batches
from perfbench.tests.smoke import SIZES

ROOT = Path(__file__).resolve().parents[2]
BIG = 2 ** 31 + 12345


def ctx(cell, seed):
    model, traffic = SIZES[cell]
    return context(ROOT, cell, seed, 1.0, "cpu", model=model,
                   traffic=traffic)


def test_serving_prompts_repeat_for_a_seed():
    a = serve_batches.prompts(ctx("olmoe-1b-7b-serve-prefill", BIG))
    b = serve_batches.prompts(ctx("olmoe-1b-7b-serve-prefill", BIG))
    c = serve_batches.prompts(ctx("olmoe-1b-7b-serve-prefill", 7))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_every_seed_gets_the_same_sizes():
    for name in ("azure-code", "azure-conversation"):
        t = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json")
                       .read_text())
        for i in range(12):
            S1, o1 = serve_batches.plan(t, BIG, i)
            S2, o2 = serve_batches.plan(t, 3, i)
            assert S1 == S2 and sorted(o1) == sorted(o2)
            assert len(o1) == t["clients"]


def test_the_mixes_sizes():
    t = json.loads((ROOT / "perfbench/traffic/azure-code.json").read_text())
    cycle = serve_batches.prompt_cycle(t)
    assert cycle == [3840, 768, 2560, 1024, 2048, 1280, 1792, 1536]
    assert all(S % 256 == 0 for S in cycle)
    assert serve_batches._levels(t["output"]) == [13]
    t = json.loads((ROOT / "perfbench/traffic/azure-conversation.json")
                   .read_text())
    assert serve_batches.prompt_cycle(t) == [1536, 704]
    outs = serve_batches._levels(t["output"])
    assert len(outs) == 32 and min(outs) == 44 and max(outs) == 256
    assert sorted(outs)[15:17] == [126, 132]     # about the median, 129


def test_the_longest_prompt_comes_first():
    for name in ("azure-code", "azure-conversation"):
        t = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json")
                       .read_text())
        cycle = serve_batches.prompt_cycle(t)
        assert cycle[0] == max(cycle) and cycle[1] == min(cycle)
        assert sorted(cycle) == serve_batches._levels(t["prompt"])
