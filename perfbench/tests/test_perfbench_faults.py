"""The check catches a broken timed path: each cell's run, past the look
for a card, at small sizes with the program in float32, with a fault
planted underneath the harness; ``correct`` comes out false."""

import time
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.tests.smoke import SIZES

ROOT = Path(__file__).resolve().parents[2]


def run(cell, seconds=3.0):
    model, traffic = SIZES[cell]
    res, checks = harness.run(ROOT, cell, 2 ** 31 + 99, seconds, False,
                              time.perf_counter(), device="cpu",
                              model=dict(model, dtype="float32"),
                              traffic=traffic)
    return res, checks


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_a_sound_run_is_correct(cell):
    res, checks = run(cell)
    assert res["correct"], checks
    assert list(res)[-1] == "checks"


def altered(real):
    """A serving step whose logits put another token first: the one the
    program itself ranks last."""
    def step(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        return -logits, cache
    return step


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("where", ["prefill", "decode_step"])
def test_a_token_altered_where_it_is_produced(monkeypatch, cell, where):
    import repro_torch.runtime.steps as steps
    monkeypatch.setattr(steps, where, altered(getattr(steps, where)))
    res, checks = run(cell)
    assert not res["correct"], checks


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_half_of_the_batch_served_the_others_answers(monkeypatch, cell):
    import repro_torch.runtime.steps as steps
    real = steps.decode_step

    def half(model, cfg, batch, cache, pos):
        logits, cache = real(model, cfg, batch, cache, pos)
        B = logits.shape[0]
        return torch.cat([logits[:B // 2], logits[:B - B // 2]]), cache

    monkeypatch.setattr(steps, "decode_step", half)
    res, checks = run(cell)
    assert not res["correct"], checks
