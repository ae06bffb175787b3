"""Device resolution shared by the package's entry points.

Every entry point (``evaluate_workflow``, ``run_paper_experiment``,
``simulate_fleet(_many)``, ``bucket_traces``, ``registry.make`` and the
method classes) takes ``device=None``: None means the card.  Without CUDA
that is an error, never a silent move to the CPU — callers that want the
plain PyTorch path on the CPU (the tests) ask for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise :class:`RuntimeError` if that is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
