"""Torch-aware lint runner for ``src/repro_torch/``: registry,
suppressions, baseline ratchet.

Counterpart of the reference's ``analysis/lint.py``.  Usage, from the
repository root (finding paths, and so the baseline's keys, are relative
to the working directory)::

    python -m repro_torch.analysis src/repro_torch            # gate
    python -m repro_torch.analysis --strict src/repro_torch   # + stale
    python -m repro_torch.analysis --update-baseline src/repro_torch

Two suppression mechanisms, both requiring a human-readable reason:

* inline — ``# lint: allow[rule] reason`` on the flagged line (or a
  standalone comment on the line above).  A reason is mandatory; a bare
  allow is itself reported as a ``bare-suppression`` finding.
* baseline — ``baseline.json`` beside this module maps
  ``"<path>::<rule>"`` to ``{"count": N, "why": "..."}``.  The gate fails
  when a file/rule pair exceeds its baselined count (the baseline can
  never grow silently); ``--strict`` additionally fails when the count
  *dropped*, forcing the baseline to be re-tightened — the ratchet only
  turns one way.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from collections import Counter

from .model import ModuleModel, build_model


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_RULES: dict[str, "Rule"] = {}


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    fn: object  # callable(LintContext) -> Iterable[Finding]


def rule(name: str):
    """Register a rule function; its docstring is the ``--list-rules`` doc."""

    def deco(fn):
        _RULES[name] = Rule(name=name, doc=(fn.__doc__ or "").strip(), fn=fn)
        return fn

    return deco


def registered_rules() -> dict[str, Rule]:
    if not _RULES:
        from . import rules  # noqa: F401  (registers on import)
    return dict(_RULES)


@dataclasses.dataclass
class LintConfig:
    """Knobs the rules consult; tests override to point at fixtures."""

    # Hot-path roots for host-sync reachability: (class-or-None, function)
    # (the reference's roots, whose names the port keeps, and the serving
    # steps of the LM substrate).
    entry_points: tuple = (
        ("ClusterSim", "run"),
        ("AdmissionState", "drain"),
        ("AdmissionState", "add_lanes"),
        ("AdmissionState", "mark_admitted"),
        ("ElasticPlanner", "drain"),
        (None, "simulate_fleet_many"),
        (None, "process_job_run"),
        ("MicroBatcher", "submit"),
        ("MicroBatcher", "_flush"),
        (None, "prefill"),
        (None, "decode_step"),
    )
    # Path fragments exempt from hot-path rules (bench/warmup/tests).
    allow_paths: tuple = ("benchmarks/", "tests/", "launch/")
    # Function-name prefixes exempt from hot-path rules.
    allow_funcs: tuple = ("bench_", "warmup", "_warmup", "main")
    max_call_depth: int = 6


@dataclasses.dataclass
class LintContext:
    models: list[ModuleModel]
    config: LintConfig

    def model_for(self, path: str) -> ModuleModel | None:
        for m in self.models:
            if m.path == path:
                return m
        return None


def collect_files(paths: list[str]) -> list[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in {"__pycache__", ".git", ".ruff_cache"})
                out.extend(os.path.join(root, f)
                           for f in sorted(files) if f.endswith(".py"))
        else:
            raise SystemExit(f"lint: no such path: {p}")
    return out


def run_lint(paths: list[str],
             config: LintConfig | None = None,
             ) -> tuple[list[Finding], list[Finding], int]:
    """Lint ``paths``; return (active, inline_suppressed, n_files).

    ``active`` still includes baselined findings — the baseline is
    applied by :func:`apply_baseline` so callers can see both sides.
    """
    config = config or LintConfig()
    models, parse_failures = [], []
    files = collect_files(paths)
    for fpath in files:
        rel = os.path.relpath(fpath).replace(os.sep, "/")
        with open(fpath, encoding="utf-8") as f:
            src = f.read()
        try:
            models.append(build_model(rel, src))
        except SyntaxError as e:
            parse_failures.append(Finding(
                rule="parse-error", path=rel, line=e.lineno or 0,
                message=str(e.msg)))
    ctx = LintContext(models=models, config=config)

    raw: list[Finding] = list(parse_failures)
    for r in registered_rules().values():
        raw.extend(r.fn(ctx))

    active, suppressed = [], []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        m = ctx.model_for(f.path)
        sup = m.suppressions.get(f.line) if m else None
        if sup is not None and sup[0] == f.rule:
            suppressed.append(f)
        else:
            active.append(f)

    # A suppression without a reason is itself a finding.
    for m in models:
        for line, (rname, reason) in sorted(m.suppressions.items()):
            if not reason:
                active.append(Finding(
                    rule="bare-suppression", path=m.path, line=line,
                    message=f"allow[{rname}] needs a justification after "
                            f"the rule name"))
    return active, suppressed, len(files)


BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {k: v for k, v in data.items() if not k.startswith("_")}


def apply_baseline(active: list[Finding], baseline: dict,
                   ) -> tuple[list[Finding], list[str], list[str]]:
    """Split active findings into (new, baselined_keys, stale_notes)."""
    counts = Counter(f.key for f in active)
    new: list[Finding] = []
    for key, grp_count in sorted(counts.items()):
        allowed = int(baseline.get(key, {}).get("count", 0))
        if grp_count > allowed:
            group = [f for f in active if f.key == key]
            # Over budget: every finding in the group is reported so the
            # author can pick which to fix or justify.
            new.extend(group)
    stale = []
    for key, entry in sorted(baseline.items()):
        allowed = int(entry.get("count", 0))
        have = counts.get(key, 0)
        if have < allowed:
            stale.append(
                f"baseline stale: {key} allows {allowed}, found {have} — "
                f"shrink it (python -m repro_torch.analysis "
                f"--update-baseline)")
    baselined = [k for k in counts if counts[k] <= int(
        baseline.get(k, {}).get("count", 0))]
    return new, baselined, stale


def write_baseline(path: str, active: list[Finding],
                   old: dict | None = None) -> dict:
    counts = Counter(f.key for f in active)
    old = old or {}
    data = {
        "_comment": "repro_torch lint suppression baseline. Keys are "
                    "'<path>::<rule>'; 'count' is the allowed number of "
                    "findings, 'why' the standing justification. "
                    "'python -m repro_torch.analysis' fails when any count "
                    "is exceeded, and (--strict) when a count goes stale "
                    "— the baseline only shrinks.",
    }
    for key in sorted(counts):
        why = old.get(key, {}).get("why", "TODO: justify")
        data[key] = {"count": counts[key], "why": why}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=False)
        f.write("\n")
    return data


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch-aware static checks for the repro_torch hot "
                    "paths")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", default=BASELINE,
                    help="suppression baseline JSON (default: the "
                         "package's analysis/baseline.json)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in registered_rules().values():
            print(f"{r.name}\n    {r.doc}\n")
        return 0

    active, suppressed, n_files = run_lint(args.paths or ["src/repro_torch"])

    if args.update_baseline:
        old = load_baseline(args.baseline)
        data = write_baseline(args.baseline, active, old)
        n_todo = sum(1 for v in data.values()
                     if isinstance(v, dict) and v.get("why", "").startswith(
                         "TODO"))
        print(f"baseline rewritten: {len(data) - 1} keys "
              f"({n_todo} need a 'why')")
        return 0

    baseline = load_baseline(args.baseline)
    new, baselined, stale = apply_baseline(active, baseline)

    print(f"repro_torch lint: {n_files} files, "
          f"{len(active)} findings "
          f"({len(suppressed)} inline-suppressed, "
          f"{len(baselined)} file/rule groups baselined)")
    status = 0
    if new:
        print("NEW findings (fix, inline-allow with a reason, or baseline):")
        for f in new:
            print("  " + f.render())
        status = 1
    if stale:
        for note in stale:
            print(("  ! " if args.strict else "  note: ") + note)
        if args.strict:
            status = 1
    if status == 0:
        print("OK")
    return status


if __name__ == "__main__":
    sys.exit(main())
