"""Launchers of the port: :mod:`repro_torch.launch.serve` (batched prefill
and decode behind KS+ admission control).  Training, dry-run and roofline
launchers are not ported yet."""
