"""Runtime contracts for the port's hot paths.

:mod:`repro_torch.analysis.contracts` — ``dispatch_budget`` /
``record_dispatch``, the runtime assertions that pin one program per
drain, one ``fleet_engine`` launch per fleet call, zero rebuilds on
churn, and no kernel build or library load on a warm serving path.

The torch-aware lint (the counterpart of ``repro.analysis.lint``) is not
ported yet.  This package must stay import-light: instrumented hot-path
modules import ``record_dispatch`` from it.
"""

from .contracts import (DispatchBudgetError, dispatch_budget,
                        record_dispatch)

__all__ = [
    "DispatchBudgetError",
    "dispatch_budget",
    "record_dispatch",
]
