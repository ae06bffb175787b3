"""The zamba2-2.7b cell on the CPU at small sizes (the program in float32,
never timed): a sound run is correct and each planted fault of Zamba2's
form makes it incorrect; the cell's three readers on synthetic records;
its frozen counts against the program's own."""

import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, trace
from perfbench.counts import flops as F
from perfbench.counts import hybrid as Y
from perfbench.counts.peaks import BF16_FLOPS_PER_S, bound_s

ROOT = Path(__file__).resolve().parents[2]
CELL = "zamba2-2.7b-serve-prefill"
Z = json.loads((ROOT / "perfbench/configs/zamba2-2.7b.json").read_text())[
    "model"]
HYB = dict(n_layers=6, d_model=64, vocab=256, ssm_state=16, ssm_headdim=16,
           ssm_chunk=16, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96,
           hybrid_layer_ids=[2, 4, 5], adapter_rank=4, dtype="float32")
TRAFFIC = dict(clients=2, pool=4, sample_tokens=8,
               prompt={"lognormal": [24, 0.6], "levels": 4, "min": 16,
                       "max": 64, "multiple": 8})


def run(seconds=2.0):
    return harness.run(ROOT, CELL, 2 ** 31 + 77, seconds, False,
                       time.perf_counter(), device="cpu", model=HYB,
                       traffic=TRAFFIC)


def test_a_sound_run_is_correct():
    res, checks = run()
    assert res["correct"], checks
    assert set(res["metrics"]) == {"setup_s", "serve_tokens_per_s",
                                   "ttft_p95_ms"}


def _no_embeddings(monkeypatch):
    from repro_torch.models import blocks
    monkeypatch.setattr(blocks, "_shared_input", lambda h, x0: torch.cat(
        [h, torch.zeros_like(x0)], dim=-1))


def _blocks_swapped(monkeypatch):
    from repro_torch.models import model
    monkeypatch.setattr(model, "_block_of",
                        lambda cfg, u: (u + 1) % cfg.num_mem_blocks)


def _into_the_residual(monkeypatch):
    from repro_torch.models import blocks
    real, real_decode = (blocks.apply_mamba2_block,
                         blocks.apply_mamba2_block_decode)

    def leaky(p, cfg, h, t=None):
        h2, *state = real(p, cfg, h, t)
        return (h2 if t is None else h2 + t), *state

    def leaky_decode(p, cfg, h, conv, ssm, t=None):
        h2, *state = real_decode(p, cfg, h, conv, ssm, t)
        return (h2 if t is None else h2 + t), *state

    monkeypatch.setattr(blocks, "apply_mamba2_block", leaky)
    monkeypatch.setattr(blocks, "apply_mamba2_block_decode", leaky_decode)


@pytest.mark.parametrize("plant", [_no_embeddings, _blocks_swapped,
                                   _into_the_residual])
def test_a_fault_of_the_form_is_incorrect(monkeypatch, plant):
    plant(monkeypatch)
    res, checks = run()
    assert not res["correct"], checks


# ------------------------------------------------------------- readers
def read(name, rec):
    return harness.reader(ROOT, name)(rec)


def record(events, spans, shapes, model=Z):
    return {"events": events, "busy_s": trace.busy_s(events),
            "window_s": 1.0, "spans": spans, "shapes": shapes,
            "model": model, "traffic": {}}


def test_the_readers_of_the_cell():
    S, B = 3840, 8
    attn = 9 * bound_s(F.attention_flops(B, S, S, 32, 160),
                       F.attention_bytes(B, S, S, 32, 32, 160, 2)) * 1e6
    scan = 54 * bound_s(Y.ssd_flops(B, S, 80, 64, 64),
                        Y.ssd_bytes(B, S, 80, 64, 1, 64, 2)) * 1e6
    ev = [("void fa3::flash_fwd_bf16<160, 64>(...)", 0, 2 * attn,
           "prefill"),
          ("void ssd3::ssd_states<64>(...)", 2 * attn, 2 * attn + scan,
           "prefill"),
          ("void ssd3::ssd_scan<64>(...)", 2 * attn + scan,
           2 * attn + 4 * scan, "prefill"),
          ("void fa3::flash_fwd_bf16<160, 64>(...)", 1e7, 1e7 + 5,
           "decode")]
    rec = record(ev, {"prefill": [(0.0, 0.5)]}, {"prefill": [[B, S]]})
    assert read("shared_attention_roofline.prefill", rec) \
        == pytest.approx(50.0)
    assert read("ssd_roofline.prefill", rec) == pytest.approx(25.0)
    assert read("mfu.hybrid_prefill", rec) == pytest.approx(
        100 * Y.model_flops_prefill(Z, B, S) / BF16_FLOPS_PER_S / 0.5)


def test_the_readers_read_nothing_of_another_family():
    olmoe = json.loads((ROOT / "perfbench/configs/olmoe-1b-7b.json")
                       .read_text())["model"]
    ev = [("void fa3::flash_fwd_bf16<128, 64>(...)", 0, 100, "prefill")]
    rec = record(ev, {"prefill": [(0.0, 0.5)]}, {"prefill": [[8, 2048]]},
                 olmoe)
    for name in ("shared_attention_roofline.prefill", "ssd_roofline.prefill",
                 "mfu.hybrid_prefill"):
        assert read(name, rec) is None, name


# -------------------------------------------------------------- counts
def _cfg():
    from perfbench.program import model_config
    return model_config({"arch": "zamba2-2.7b-zyphra", "model": Z})


@pytest.mark.parametrize("S", [768, 1536, 3840])
def test_frozen_counts_equal_the_programs(S):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    cfg, B = _cfg(), 8
    H, P, G, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups, \
        cfg.ssm_state
    assert Y.ssm_widths(Z) == (cfg.d_inner, H, P, G, N) == (5120, 80, 64, 1,
                                                              64)
    assert Y.ssd_flops(B, S, H, P, N) == ssd_ops.flops(B, S, H, P, N)
    assert Y.ssd_bytes(B, S, H, P, G, N, 2) \
        == ssd_ops.io_bytes(B, S, H, P, G, N, 2)
    assert F.attention_flops(B, S, S, 32, 160) \
        == flash_ops.flops(B, S, S, 32, 160, True, None)
    assert F.attention_bytes(B, S, S, 32, 32, 160, 2) \
        == flash_ops.io_bytes(B, S, S, 32, 32, 160, 2)


def test_weights_a_token_meets_are_the_programs():
    """Each Mamba2 layer's products and conv, and each use's block (the
    block its use runs), adapter and linear, from the program's own
    parameter shapes."""
    from repro_torch.models.model import _block_of, param_shapes
    cfg = _cfg()
    uses = len(cfg.hybrid_layer_ids)
    runs = [sum(_block_of(cfg, u) == b for u in range(uses))
            for b in range(cfg.num_mem_blocks)]
    assert runs == [5, 4]
    total = 0
    for name, shape in param_shapes(cfg).items():
        n = math.prod(shape)
        parts = name.split(".")
        if parts[0] == "blocks" and parts[-1] in ("in_proj", "out_proj",
                                                   "conv_w"):
            total += n
        elif parts[0] == "shared" and len(shape) == 2:
            total += runs[int(parts[1])] * n
        elif parts[0] == "uses":
            total += n
    assert Y.weights_per_token(Z) == total
    assert 3.76e9 < total < 3.78e9
    head = 2 * 2560 * 32000 * 8
    want = 2 * total * 8 * 2048 + head \
        + 9 * F.attention_flops(8, 2048, 2048, 32, 160) \
        + 54 * Y.ssd_flops(8, 2048, 80, 64, 64)
    assert Y.model_flops_prefill(Z, 8, 2048) == want
    assert np.isclose(Y.model_flops_prefill(Z, 8, 2048) / (8 * 2048),
                      2 * total, rtol=0.1)
