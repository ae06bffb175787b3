"""Workflow trace substrate: synthetic nf-core-like generators."""

from repro_torch.traces.generator import (
    Execution,
    Phase,
    TaskFamily,
    Workflow,
    eager,
    sarek,
)

__all__ = ["Execution", "Phase", "TaskFamily", "Workflow", "eager", "sarek"]
