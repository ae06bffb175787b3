"""BENCHMARK.json against the benchmark's contract: keys, names, units,
and a file under ``perfbench/`` for everything it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer"):
                if key in e:
                    assert LINE.match(e[key]), e[key]
            if group == "configs":
                assert LINE.match(e["source"])
            else:
                assert UNIT.match(e.get("unit", "x")), e
                assert e.get("better", "lower") in ("lower", "higher")
    assert len(names) == len(set(names))


def test_entries_have_only_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/configs/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_setup_s_and_reporting():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in MAN["workloads"]}
    for w in cells:
        reported = [n for n, m in e2e.items()
                    if w in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, w
        assert any(w in m["workloads"] for m in MAN["per_layer"]), w
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_has_its_files(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    spec = json.loads((ROOT / conf["file"]).read_text())
    assert spec["source"] == conf["source"]
    assert spec["reduced"] == conf["reduced"]
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "kinds" / f"{mix['kind']}.py").is_file()
    assert (BENCH / "reference" / f"{spec['model']['family']}.py").is_file()
    limits = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert limits["limits"]


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    metrics = {m["name"] for m in MAN["per_layer"]}
    readers = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert metrics == readers


def test_files_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
