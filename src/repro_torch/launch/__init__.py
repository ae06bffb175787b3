"""Launchers of the port: :mod:`repro_torch.launch.serve` (batched prefill
and decode behind KS+ admission control), :mod:`repro_torch.launch.train`
(the fault-tolerant training loop, one card), and the dry run on the
production meshes: :mod:`~repro_torch.launch.shapes` (cells),
:mod:`~repro_torch.launch.mesh` (meshes, H100 constants),
:mod:`~repro_torch.launch.partitioning` (logical axes as DTensor
placements), :mod:`~repro_torch.launch.dryrun` and
:mod:`~repro_torch.launch.roofline`."""
