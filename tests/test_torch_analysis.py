"""The port's torch-aware lint (``repro_torch.analysis``): its three rules,
suppressions, the baseline ratchet and the gate over ``src/repro_torch``,
as ``tests/test_analysis.py`` holds the reference's.

Rule tests run the real lint over fixture modules written to
``tmp_path``: each isolates one hazard of the package's idioms, beside the
clean twin that must not be flagged.  The gate test pins the acceptance
criterion: ``python -m repro_torch.analysis --strict src/repro_torch``
exits 0 against the committed baseline, which carries the drains' host
reads as findings with their reasons.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis.lint import (BASELINE, LintConfig, apply_baseline,
                                       load_baseline, main as lint_main,
                                       run_lint, write_baseline)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join("src", "repro_torch")


def _lint_src(tmp_path, source, config=None, name="mod.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    active, suppressed, _ = run_lint([str(p)], config=config)
    return active, suppressed


def _by_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


_SYNC_CFG = LintConfig(entry_points=((None, "loop"),), allow_paths=(),
                       allow_funcs=("bench_",))


# ----------------------------------------------------- host-sync-in-hot-path
class TestHostSyncInHotPath:
    SRC = """
import numpy as np
import torch

def helper(x):
    y = torch.where(x > 0, x, 0.0)
    return y.cpu()

def loop(x):
    for _ in range(3):
        x = helper(x)
    v = torch.zeros(4).sum()
    host = np.arange(3)
    torch.cuda.synchronize()
    return float(v) + v.item() + len(host.tolist())

def bench_probe(x):
    return torch.ones(2).cpu()

def unreachable(x):
    return torch.ones(2).item()
"""

    def test_reachable_syncs_flagged_allowlist_respected(self, tmp_path):
        active, _ = _lint_src(tmp_path, self.SRC, config=_SYNC_CFG)
        found = _by_rule(active, "host-sync-in-hot-path")
        msgs = sorted(f.message for f in found)
        assert len(found) == 4, msgs
        assert any(".cpu()" in m for m in msgs)       # helper (reachable)
        assert any(".item()" in m for m in msgs)      # loop (entry itself)
        assert any("float()" in m for m in msgs)      # of a torch value
        assert any("synchronize" in m for m in msgs)
        # numpy's .tolist(), bench_ and the unreachable function: silent

    def test_bound_method_dispatch_counts_as_reachable(self, tmp_path):
        """``program = self._run; program(x)`` must not hide the callee."""
        active, _ = _lint_src(tmp_path, """
import torch

class Sim:
    def loop(self, x):
        program = self._run
        return program(x)

    def _run(self, x):
        v = torch.as_tensor(x).sum()
        return int(v)
""", config=LintConfig(entry_points=(("Sim", "loop"),), allow_paths=(),
                       allow_funcs=()))
        found = _by_rule(active, "host-sync-in-hot-path")
        assert len(found) == 1 and "int()" in found[0].message

    def test_kernel_ops_and_tensor_methods_taint(self, tmp_path):
        """A kernel wrapper's ``ops.*`` result and the tensor methods of a
        device value are device values; a host array and a tensor's shape
        are not."""
        active, _ = _lint_src(tmp_path, """
import numpy as np
from repro_torch.kernels.wastage import ops

def loop(table, dt):
    v, _, _ = ops.oom_probe_groups(table, dt)
    w = v.float().sum(dim=0)
    a = np.asarray(w)
    b = w.numpy()
    n = int(v.shape[0])
    host = np.zeros(3)
    return a, b, n, host.tolist(), bool(host.any())
""", config=_SYNC_CFG)
        found = _by_rule(active, "host-sync-in-hot-path")
        msgs = sorted(f.message for f in found)
        assert len(found) == 2, msgs
        assert any("np.asarray" in m for m in msgs)
        assert any("`.numpy()`" in m for m in msgs)


# ------------------------------- host-sync: control flow on a device value
class TestControlFlowOnDeviceValue:
    def test_branch_on_device_value_flagged(self, tmp_path):
        active, _ = _lint_src(tmp_path, """
import torch

def loop(x):
    flag = torch.as_tensor(x) > 0
    if flag.any():
        return 1
    return 0

def converted(x):
    flag = torch.as_tensor(x) > 0
    if bool(flag.any()):
        return 1
    return 0

def host_only(x):
    n = len(x)
    while n > 0:
        n -= 1
    out = {}
    out["a"] = torch.ones(1)
    if "a" in out:
        return n
    return -1
""", config=LintConfig(entry_points=((None, "loop"), (None, "converted"),
                                     (None, "host_only")),
                       allow_paths=(), allow_funcs=()))
        found = _by_rule(active, "host-sync-in-hot-path")
        msgs = sorted(f.message for f in found)
        assert len(found) == 2, msgs
        assert any("`if` branches on `flag`" in m for m in msgs)
        assert any("`bool()`" in m for m in msgs)  # the conversion itself

    def test_while_on_device_value_flagged(self, tmp_path):
        active, _ = _lint_src(tmp_path, """
import torch

def loop(x):
    done = torch.zeros((), dtype=torch.bool)
    while not done:
        done = torch.as_tensor(x).all()
    return x
""", config=_SYNC_CFG)
        found = _by_rule(active, "host-sync-in-hot-path")
        assert len(found) == 1 and "`while`" in found[0].message


# ----------------------------------------------------------- implicit-float32
class TestImplicitFloat32:
    SRC = """
import torch

def bad(n, dev):
    a = torch.zeros(n, device=dev)
    b = torch.full((n,), 1.5, device=dev)
    c = torch.tensor([0.5, 1.0])
    d = torch.arange(n, device=dev)
    e = torch.ones(2)
    return a, b, c, d, e

def good(n, dev):
    a = torch.zeros(n, dtype=torch.float64, device=dev)
    b = torch.full((n,), 1.5, dtype=torch.float64, device=dev)
    c = torch.tensor([0.5, 1.0], dtype=torch.float64)
    d = torch.arange(n, dtype=torch.int64, device=dev)
    return a, b, c, d, torch.empty(2)
"""

    @pytest.mark.parametrize("module", ["sched/admission.py",
                                        "core/envelope.py",
                                        "kernels/admission/ref.py"])
    def test_float64_modules_flagged(self, tmp_path, module):
        active, _ = _lint_src(tmp_path, self.SRC, name=module)
        found = _by_rule(active, "implicit-float32")
        assert len(found) == 5, found
        assert all(f.line < 11 for f in found)  # all in bad()
        assert {f.message.split("(")[0] for f in found} == {
            "`torch.zeros", "`torch.full", "`torch.tensor", "`torch.arange",
            "`torch.ones"}

    def test_other_modules_clean(self, tmp_path):
        active, _ = _lint_src(tmp_path, self.SRC, name="core/fleet.py")
        assert _by_rule(active, "implicit-float32") == []


# ------------------------------------------------ unguarded-obs-in-hot-path
_OBS_CFG = LintConfig(entry_points=((None, "loop"),), allow_paths=(),
                      allow_funcs=("bench_",))


class TestUnguardedObsInHotPath:
    SRC = """
from repro_torch.obs import metrics as _met
from repro_torch.obs import trace as _obs

def helper():
    _obs.instant("tick")          # reachable via loop -> flagged

def loop(x):
    helper()
    with _obs.span("work"):       # unguarded -> flagged
        x = x + 1
    if _obs.enabled:
        _met.counter("c").inc()   # guarded -> clean
        with _obs.span("ok") as sp:
            sp.add(n=1)
    return x

def unreachable(x):
    _met.gauge("g").set(x)        # not in the hot path -> silent

def bench_loop(x):
    _obs.instant("bench")         # allow_funcs prefix -> silent
"""

    def test_unguarded_calls_flagged_guarded_clean(self, tmp_path):
        active, _ = _lint_src(tmp_path, self.SRC, config=_OBS_CFG)
        found = _by_rule(active, "unguarded-obs-in-hot-path")
        msgs = sorted(f.message for f in found)
        assert len(found) == 2, msgs
        assert any("_obs.instant" in m and "helper" in m for m in msgs)
        assert any("_obs.span" in m and "loop" in m for m in msgs)

    def test_obs_subsystem_itself_exempt(self, tmp_path):
        active, _ = _lint_src(tmp_path, """
def loop(name):
    import trace
    trace.instant("self")
""", config=_OBS_CFG, name="repro_torch/obs/trace.py")
        assert _by_rule(active, "unguarded-obs-in-hot-path") == []

    def test_package_instrumentation_is_guarded(self):
        paths = [os.path.join(REPO_ROOT, PORT_SRC, p) for p in
                 ("sched/cluster.py", "sched/admission.py", "core/fleet.py",
                  "serve/batcher.py", "serve/server.py")]
        active, _, _ = run_lint(paths)
        assert _by_rule(active, "unguarded-obs-in-hot-path") == []


# ---------------------------------------------------- suppressions + baseline
class TestSuppressionsAndBaseline:
    SRC = """
import torch

def loop(x):
    y = torch.as_tensor(x)
    a = float(y)  # lint: allow[host-sync-in-hot-path] readback is the API
    # lint: allow[host-sync-in-hot-path] standalone comment form
    b = float(y)
    c = float(y)
    return a + b + c
"""

    def test_inline_allow_suppresses_with_reason(self, tmp_path):
        active, suppressed = _lint_src(tmp_path, self.SRC, config=_SYNC_CFG)
        assert len(suppressed) == 2  # same-line and next-line forms
        remaining = _by_rule(active, "host-sync-in-hot-path")
        assert len(remaining) == 1  # the un-suppressed float(y)
        assert _by_rule(active, "bare-suppression") == []

    def test_bare_allow_is_itself_a_finding(self, tmp_path):
        active, suppressed = _lint_src(tmp_path, """
import torch

def loop(x):
    return torch.as_tensor(x).item()  # lint: allow[host-sync-in-hot-path]
""", config=_SYNC_CFG)
        found = _by_rule(active, "bare-suppression")
        assert found and "justification" in found[0].message
        assert len(suppressed) == 1

    def test_wrong_rule_allow_does_not_suppress(self, tmp_path):
        active, suppressed = _lint_src(tmp_path, """
import torch

def loop(x):
    return float(torch.as_tensor(x))  # lint: allow[implicit-float32] no
""", config=_SYNC_CFG)
        assert suppressed == []
        assert len(_by_rule(active, "host-sync-in-hot-path")) == 1

    def test_baseline_ratchet(self, tmp_path):
        active, _ = _lint_src(tmp_path, self.SRC, config=_SYNC_CFG)
        findings = _by_rule(active, "host-sync-in-hot-path")
        key = findings[0].key
        # equal count -> clean; over -> new; under -> stale
        new, baselined, stale = apply_baseline(
            findings, {key: {"count": 1, "why": "pinned"}})
        assert new == [] and baselined == [key] and stale == []
        new, _, _ = apply_baseline(findings, {})
        assert new == findings
        new, _, stale = apply_baseline(
            findings, {key: {"count": 3, "why": "was worse"}})
        assert new == [] and len(stale) == 1 and "shrink" in stale[0]

    def test_write_and_load_roundtrip(self, tmp_path):
        active, _ = _lint_src(tmp_path, self.SRC, config=_SYNC_CFG)
        findings = _by_rule(active, "host-sync-in-hot-path")
        bpath = tmp_path / "baseline.json"
        write_baseline(str(bpath), findings,
                       {findings[0].key: {"count": 9, "why": "kept"}})
        data = load_baseline(str(bpath))
        assert data[findings[0].key] == {"count": 1, "why": "kept"}
        assert json.loads(bpath.read_text())["_comment"]

    def test_gate_fails_on_growth_and_strict_on_a_drop(self, tmp_path,
                                                       monkeypatch):
        src = tmp_path / "simulate.py"
        # simulate_fleet_many is a default entry point
        src.write_text("import torch\n\ndef simulate_fleet_many(x):\n"
                       "    return torch.as_tensor(x).item()\n")
        monkeypatch.chdir(tmp_path)
        base = tmp_path / "base.json"
        key = "simulate.py::host-sync-in-hot-path"
        assert lint_main(["simulate.py", "--baseline", str(base)]) == 1
        base.write_text(json.dumps({key: {"count": 1, "why": "pinned"}}))
        assert lint_main(["simulate.py", "--baseline", str(base),
                          "--strict"]) == 0
        base.write_text(json.dumps({key: {"count": 2, "why": "was worse"}}))
        assert lint_main(["simulate.py", "--baseline", str(base)]) == 0
        assert lint_main(["simulate.py", "--baseline", str(base),
                          "--strict"]) == 1
        assert lint_main(["simulate.py", "--baseline", str(base),
                          "--update-baseline"]) == 0
        assert load_baseline(str(base))[key] == {"count": 1,
                                                 "why": "was worse"}


# ----------------------------------------------------------------- the gate
class TestGate:
    def test_package_exits_zero_strict(self, monkeypatch):
        """``python -m repro_torch.analysis --strict src/repro_torch`` is
        clean against the committed baseline, and strictly so."""
        monkeypatch.chdir(REPO_ROOT)
        assert lint_main([PORT_SRC, "--strict"]) == 0

    def test_module_entry_point(self):
        r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                            "--strict", PORT_SRC], cwd=REPO_ROOT,
                           env=dict(os.environ, PYTHONPATH="src"),
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr

    def test_baselined_findings_have_reasons(self):
        baseline = load_baseline(BASELINE)
        assert baseline
        for key, entry in baseline.items():
            assert entry["why"] and not entry["why"].startswith("TODO"), key

    def test_drain_read_is_a_baselined_finding(self, monkeypatch):
        """The drain programs' host reads are findings the rule sees, kept
        by the baseline with their reasons: one a drain for the one-device
        program (its kernel's vector), one an iteration for the sharded
        program and for the plain loop the CPU route runs."""
        monkeypatch.chdir(REPO_ROOT)
        adm = os.path.join(PORT_SRC, "sched", "admission.py")
        plain = os.path.join(PORT_SRC, "kernels", "admission", "ref.py")
        active, suppressed, _ = run_lint([PORT_SRC])
        at = {(f.path, f.line) for f in active
              if f.rule == "host-sync-in-hot-path"}
        for path, marker, why in (
                (adm, "the one host read of this drain", "drain"),
                (adm, "the one host read of this iteration", "sharded"),
                (plain, "the host read of this iteration", "plain_drain")):
            with open(path) as f:
                lines = f.read().splitlines()
            reads = [i + 2 for i, line in enumerate(lines) if marker in line]
            assert len(reads) == 1, (path, marker)
            rel = path.replace(os.sep, "/")
            assert (rel, reads[0]) in at, (reads[0], sorted(at))
            entry = load_baseline(BASELINE)[f"{rel}::host-sync-in-hot-path"]
            assert why in entry["why"]
            assert not any(f.path == rel for f in suppressed)

    def test_list_rules_runs(self, capsys):
        assert lint_main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for name in ("host-sync-in-hot-path", "implicit-float32",
                     "unguarded-obs-in-hot-path"):
            assert name in out
        for name in ("use-after-donation", "x64-scope", "recompile-hazard"):
            assert name not in out
