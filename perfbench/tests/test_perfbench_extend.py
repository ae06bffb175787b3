"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files of their own and entries, and edits no file."""

import hashlib
import json
import shutil
import time

from perfbench import harness

from perfbench.tests.smoke import MOE

ROOT = harness.Path(__file__).resolve().parents[2]


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in (root / "perfbench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts}


def test_add_a_config_a_mix_a_cell_and_a_metric(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    bench = tmp_path / "perfbench"

    spec = json.loads((bench / "configs/olmoe-1b-7b.json").read_text())
    spec.update(arch="olmoe-1b-7b", reduced=["n_layers"])
    spec["model"].update(MOE, dtype="float32")
    (bench / "configs/olmoe-mini.json").write_text(json.dumps(spec))
    (bench / "traffic/tiny-chat.json").write_text(json.dumps({
        "kind": "serve_batches", "clients": 2, "prompt": {"fixed": 16},
        "output": {"fixed": 3}, "pool": 2, "sample_tokens": 4}))
    (bench / "workloads/olmoe-mini-chat.json").write_text(json.dumps(
        {"limits": {"served_gap": 1e-3}}))
    (bench / "metrics/prefills.serve.py").write_text(
        "def read(rec):\n    p = rec['spans'].get('prefill')\n"
        "    return float(len(p)) if p else None\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "olmoe-mini", "source": spec["source"],
                           "file": "perfbench/configs/olmoe-mini.json",
                           "reduced": ["n_layers"], "why": "a test"})
    man["workloads"].append({"name": "olmoe-mini-chat", "config": "olmoe-mini",
                             "traffic": "tiny-chat", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append("olmoe-mini-chat")
    man["per_layer"].append({"name": "prefills.serve", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "runtime.steps (serve steps)",
                             "moves": "serve_tokens_per_s",
                             "workloads": ["olmoe-mini-chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    res, checks = harness.run(tmp_path, "olmoe-mini-chat", 3, 0.5, False,
                              time.perf_counter(), device="cpu")
    assert res["correct"], checks
    assert set(res["metrics"]) == {"setup_s", "serve_tokens_per_s"}
    entry = man["per_layer"][-1]
    assert harness.reports(entry, "olmoe-mini-chat")
    assert harness.reader(tmp_path, "prefills.serve")(
        {"spans": {"prefill": [(0, 1), (1, 2)]}}) == 2.0
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
