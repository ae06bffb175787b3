"""The frozen counts at the cells' shapes, against hand computations."""

import json
from pathlib import Path

import pytest

from perfbench.counts import flops as F
from perfbench.counts.peaks import bound_s

ROOT = Path(__file__).resolve().parents[2]
O = json.loads((ROOT / "perfbench/configs/olmoe-1b-7b.json").read_text())[
    "model"]


@pytest.mark.parametrize("S", [768, 1536, 3840])
def test_attention_at_the_prefill_shapes(S):
    pairs = S * (S + 1) // 2
    assert F.attended_pairs(S, S) == pairs
    assert F.attended_pairs(S, S + 13) == pairs       # keys past the query
    assert F.attention_flops(8, S, S, 16, 128) == 4 * 128 * 8 * 16 * pairs
    rows = 8 * S * 16 * 128
    assert F.attention_bytes(8, S, S, 16, 16, 128, 2) == 4 * rows * 2


def test_model_flops_of_olmoe_prefill_count_the_head_once_a_prompt():
    layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert F.weights_per_token(O) == 16 * layer == 1_075_838_976
    head = 2048 * 50304
    attn = 16 * 4 * 128 * 16 * 8 * (2048 * 2049 // 2)
    assert F.model_flops_prefill(O, 8, 2048) \
        == 2 * 16 * layer * 8 * 2048 + 2 * head * 8 + attn


def test_bound_takes_the_larger_term():
    assert bound_s(989e12, 0) == 1.0
    assert bound_s(0, 3.35e12) == 1.0
    assert bound_s(989e12, 6.7e12) == 2.0
