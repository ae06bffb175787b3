"""Workload subsystem: synthetic generation, wfcommons import, scenarios.

Three layers over one representation (:class:`WorkflowTrace` — packed
``(B, T)`` fleet lanes on a device + per-task metadata + DAG edges):

* :mod:`repro_torch.workloads.generate` — seeded task-family recipes
  synthesized on the device straight into the fleet engine's lane layout,
  plus DAG shape helpers (chains, fan-out, layered, barrier waves) and
  the carry-over of a trace's state between devices and packages
  (:func:`trace_state` / :func:`load_workflow_trace`);
* :mod:`repro_torch.workloads.wfc` — wfcommons/WorkflowHub JSON instance
  import and export with loud schema/cycle validation;
* :mod:`repro_torch.workloads.scenarios` — the named scenario catalog
  (``burst_arrival``, ``heavy_tail``, ``deep_chain``, ``wide_fanout``,
  ``hetero_dt``, ``workload_replay``) consumed by ``evaluate_workflow``,
  ``chip_smoke.py`` and the tests.

Two timing layers ride on top: :mod:`repro_torch.workloads.arrivals`
(seeded Poisson / diurnal / trace-driven release times, decoupled from DAG
structure) and :mod:`repro_torch.workloads.suite` (the scenario x arrival
x fault robustness grid — ``make_suite`` / ``run_suite``).

Every entry point that builds traces takes ``device=None``: None means the
card, and without CUDA that raises.
"""

from repro_torch.workloads import scenarios, wfc
from repro_torch.workloads.arrivals import (
    diurnal_arrivals,
    poisson_arrivals,
    trace_arrivals,
    with_arrivals,
)
from repro_torch.workloads.generate import (
    SHAPES,
    FamilyRecipe,
    ScenarioWorkflow,
    WorkflowTrace,
    assert_release_order,
    barrier_parents,
    chain_parents,
    fanout_parents,
    layered_parents,
    load_workflow_trace,
    materialize_traces,
    synthesize,
    trace_state,
)
from repro_torch.workloads.scenarios import (
    SCENARIOS,
    register_scenario,
    scenario_names,
)
from repro_torch.workloads.suite import (
    SuiteCase,
    make_suite,
    run_suite,
    suite_table,
)
from repro_torch.workloads.wfc import (
    export_instance,
    import_instance,
    load_instance,
    validate_dag_ids,
)

__all__ = [
    "SHAPES", "FamilyRecipe", "WorkflowTrace", "ScenarioWorkflow",
    "synthesize", "materialize_traces", "assert_release_order",
    "chain_parents", "fanout_parents", "layered_parents", "barrier_parents",
    "trace_state", "load_workflow_trace",
    "scenarios", "SCENARIOS", "register_scenario", "scenario_names",
    "poisson_arrivals", "diurnal_arrivals", "trace_arrivals",
    "with_arrivals",
    "SuiteCase", "make_suite", "run_suite", "suite_table",
    "wfc", "load_instance", "import_instance", "export_instance",
    "validate_dag_ids",
]
