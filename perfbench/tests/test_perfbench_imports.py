"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the
program; a run without a card fails rather than falling back."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    """Top-level names of the modules a source file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def harness_sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in harness_sources():
        assert not imported(p) & FORBIDDEN, p
    # compared whole: the program's name begins with the JAX package's
    assert "repro_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        names = imported(p)
        assert not names & (FORBIDDEN | {"repro_torch"}), p
        assert names <= {"__future__", "math", "torch", "perfbench"}, p
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("perfbench"):
                assert node.module.startswith("perfbench.reference"), p


RUN = """
import sys, json, time
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from perfbench import harness
from perfbench.tests.smoke import SIZES
model, traffic = SIZES[{cell!r}]
res, _ = harness.run(Path({root!r}), {cell!r}, 5, 3.0, False,
                     time.perf_counter(), device="cpu",
                     model=dict(model, dtype="float32"),
                     traffic=traffic)
print(json.dumps({{"correct": res["correct"],
                   "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax_module():
    cell = "olmoe-1b-7b-serve-decode"
    code = RUN.format(root=str(ROOT), src=str(ROOT / "src"), cell=cell)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert not set(res["modules"]) & FORBIDDEN
    assert "repro_torch" in res["modules"]


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "olmoe-1b-7b-serve-decode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
