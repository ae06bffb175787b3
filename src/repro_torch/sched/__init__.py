"""Scheduler layer: trace-driven evaluation (the paper's experiment).

Only the simulator is carried over so far; admission, the cluster
simulator, elastic planning, faults and monitoring follow (ROADMAP A6).
"""

from repro_torch.sched.simulator import (
    ExperimentResult,
    MethodResult,
    evaluate_workflow,
    run_paper_experiment,
)

__all__ = [
    "ExperimentResult", "MethodResult",
    "evaluate_workflow", "run_paper_experiment",
]
