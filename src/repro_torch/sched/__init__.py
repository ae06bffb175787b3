"""Scheduler layer: trace-driven evaluation, cluster sim, monitoring, elastic.

Every entry point that touches a device takes ``device=None``: None means
the card, and without CUDA that raises.
"""

from repro_torch.sched.admission import AdmissionState
from repro_torch.sched.cluster import (
    ClusterResult,
    ClusterSim,
    Job,
    Node,
    OffsetCandidate,
)
from repro_torch.sched.elastic import ElasticPlanner, plan_mesh
from repro_torch.sched.faults import FaultEvent, FaultSchedule
from repro_torch.sched.monitor import (
    HBMFootprintModel,
    MemoryMonitor,
    read_rss_gb,
)
from repro_torch.sched.simulator import (
    ExperimentResult,
    MethodResult,
    evaluate_workflow,
    run_paper_experiment,
)

__all__ = [
    "AdmissionState",
    "ClusterResult", "ClusterSim", "Job", "Node", "OffsetCandidate",
    "ElasticPlanner", "plan_mesh",
    "FaultEvent", "FaultSchedule",
    "HBMFootprintModel", "MemoryMonitor", "read_rss_gb",
    "ExperimentResult", "MethodResult",
    "evaluate_workflow", "run_paper_experiment",
]
