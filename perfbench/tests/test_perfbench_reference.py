"""The plain reference against the program at small sizes on the CPU,
both in float32 (the test may import both; the reference imports nothing
of the program)."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import weights as W
from perfbench.program import build_model, model_config
from perfbench.reference import common, moe
from perfbench.tests.smoke import MOE

ROOT = Path(__file__).resolve().parents[2]


def spec(name, small):
    s = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
    s["model"].update(small, dtype="float32")
    return s


@pytest.mark.parametrize("small", [
    MOE, dict(MOE, capacity_factor=0.5)])      # with drops too
def test_serving_matches_the_program(small):
    from repro_torch.runtime import make_decode_step, make_prefill_step
    s = spec("olmoe-1b-7b", small)
    m, cfg = s["model"], model_config(s)
    weights = W.make(moe.param_defs(m), 11, "cpu")
    model = build_model(cfg, weights)
    B, S, n = 3, 20, 5
    toks = torch.randint(0, m["vocab"], (B, S),
                         generator=torch.Generator().manual_seed(1))
    logits, cache = make_prefill_step(cfg, capacity=S + n)(model,
                                                           {"tokens": toks})
    got, served = [logits[:, -1]], [logits[:, -1].argmax(-1)]
    decode = make_decode_step(cfg)
    for j in range(1, n):
        pos = torch.full((B,), S + j - 1, dtype=torch.int32)
        logits, cache = decode(model, {"tokens": served[-1]}, cache, pos)
        got.append(logits[:, -1])
        served.append(logits[:, -1].argmax(-1))
    want = moe.serve_logits(weights, m, toks, torch.stack(served, 1))
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=1e-4,
                               atol=1e-4)


def test_moe_capacity_is_the_programs():
    from repro_torch.models.moe import moe_capacity
    m = {"topk": 8, "n_experts": 64, "capacity_factor": 1.25}
    for T in (8, 32, 8 * 1024, 8 * 5376, 32 * 512):
        assert moe.capacity(T, m) == moe_capacity(T, 64, 8, 1.25)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 448.0, -3.3])
    q = common.fake_fp8(x)
    assert q[0] == 1.0 and q[2] == 448.0
    assert (q - x).abs().max() <= 0.07 * x.abs().max()
