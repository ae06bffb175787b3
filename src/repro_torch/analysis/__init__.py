"""Static analysis and runtime contracts for the port's hot paths.

Two halves, as in the reference's ``analysis`` package:

* :mod:`repro_torch.analysis.lint` / :mod:`repro_torch.analysis.rules` —
  the AST-based, torch-aware checker (``python -m repro_torch.analysis
  src/repro_torch``): host-sync-in-hot-path, implicit-float32 and
  unguarded-obs-in-hot-path, gated by an inline-allow + baseline ratchet
  (``analysis/baseline.json``);
* :mod:`repro_torch.analysis.contracts` — ``dispatch_budget`` /
  ``record_dispatch``, the runtime assertions that pin one program per
  drain, one ``fleet_engine`` launch per fleet call, zero rebuilds on
  churn, and no kernel build or library load on a warm serving path.

This package must stay import-light: instrumented hot-path modules import
``record_dispatch`` from it.
"""

from .contracts import (DispatchBudgetError, dispatch_budget,
                        record_dispatch)
from .lint import Finding, LintConfig, run_lint

__all__ = [
    "DispatchBudgetError",
    "dispatch_budget",
    "record_dispatch",
    "Finding",
    "LintConfig",
    "run_lint",
]
