"""Launchers of the port: :mod:`repro_torch.launch.serve` (batched prefill
and decode behind KS+ admission control) and :mod:`repro_torch.launch.train`
(the fault-tolerant training loop).  The dry-run, mesh, partitioning and
roofline launchers are not ported yet (ROADMAP A11d)."""
