"""The per-layer readers on recorded synthetic traces."""

import json
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench.counts import flops as F
from perfbench.counts.peaks import BF16_FLOPS_PER_S, bound_s

ROOT = Path(__file__).resolve().parents[2]
MAN = harness.manifest(ROOT)
O = json.loads((ROOT / "perfbench/configs/olmoe-1b-7b.json").read_text())[
    "model"]


def read(name, rec):
    return harness.reader(ROOT, name)(rec)


def record(events, window_s, spans, shapes, model):
    return {"events": events, "busy_s": trace.busy_s(events),
            "window_s": window_s, "spans": spans, "shapes": shapes,
            "model": model, "traffic": {}}


def prefill_record(scale=1.0):
    S = 2048
    fa = O["n_layers"] * bound_s(
        F.attention_flops(8, S, S, 16, 128),
        F.attention_bytes(8, S, S, 16, 16, 128, 2)) * 1e6 * scale
    ev = [("void fa3::flash_fwd_bf16<1>(...)", 0, fa, "prefill"),
          ("cub::DeviceRadixSortOnesweepKernel", fa, fa + 1e4, "prefill"),
          ("indexSelectLargeIndex", fa + 1e4, fa + 3e4, "prefill"),
          ("sm90_xmma_gemm_bf16", fa + 3e4, fa + 2e5, "prefill"),
          ("index_elementwise_kernel", 3e5, 3.1e5, "decode")]
    spans = {"prefill": [(0.0, 0.25)], "decode": [(0.25, 0.3), (0.3, 0.4)]}
    return record(ev, 0.5, spans, {"prefill": [[8, S]]}, O)


def test_serving_readers():
    rec = prefill_record(scale=2.0)
    assert read("decode_step_ms", rec) == pytest.approx(75.0)
    assert read("device_ms.moe_dispatch.prefill", rec) == pytest.approx(30.0)
    assert read("flash_attention_roofline.prefill", rec) == pytest.approx(50.0)
    assert read("mfu.prefill", rec) == pytest.approx(
        100 * F.model_flops_prefill(O, 8, 2048) / BF16_FLOPS_PER_S / 0.25)
    busy = rec["busy_s"]
    assert read("idle_share.serve", rec) == pytest.approx(100 * (1 - busy / 0.5))


def test_no_share_passes_100_when_the_kernels_run_at_their_bound():
    rec = prefill_record(1.0)
    for m in MAN["per_layer"]:
        if m["unit"] == "%":
            value = read(m["name"], rec)
            assert value is None or value <= 100.0 + 1e-9, m["name"]


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = record([], 1.0, {}, {}, O)
    for m in MAN["per_layer"]:
        assert read(m["name"], empty) is None, m["name"]


def test_breakdown_names_ops_and_idle_by_phase():
    ev = [("void a::k1<1>(int)", 0.0, 10.0, "prefill"),
          ("k2", 20.0, 25.0, "prefill"), ("k2", 40.0, 45.0, "decode")]
    out = trace.breakdown(ev)
    assert out["device_ops"][0] == ["a::k1", 10.0 / 1e6]
    assert dict(out["idle_gaps"]) == {"prefill": 10.0 / 1e6,
                                      "prefill->decode": 15.0 / 1e6}
    assert trace.busy_s(ev) == pytest.approx(20.0 / 1e6)
