"""KS+ admission kernels: the fits columns and the one-launch greedy drain."""

from repro_torch.kernels.admission.ops import (LAUNCHES, admit_columns,
                                               admit_drain)

__all__ = ["LAUNCHES", "admit_columns", "admit_drain"]
