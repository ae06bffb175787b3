"""Device resolution shared by the package's entry points.

Every entry point (``evaluate_workflow``, ``run_paper_experiment``,
``simulate_fleet(_many)``, ``bucket_traces``, ``registry.make`` and the
method classes; ``models.init_params``, ``load_jax_params`` and
``init_cache``) takes ``device=None``: None means the card.  Without CUDA
that is an error, never a silent move to the CPU — callers that want the
plain PyTorch path on the CPU (the tests) ask for it with ``device="cpu"``.

A path that runs collectives (the training loop's mesh, the node-sharded
admission drain) runs over the caller's process group when one is up, and
otherwise over a one-rank group that :func:`process_world` starts and
destroys again (:func:`group_backend` names its backend).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "group_backend", "process_world"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise :class:`RuntimeError` if that is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def group_backend(device) -> str:
    """The process-group backend whose collectives take tensors on
    ``device``: gloo for the CPU; for the card NCCL, beside gloo for the
    host tensors a group also meets."""
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" \
        else "gloo"


@contextlib.contextmanager
def process_world(device):
    """Scope of a collective path on ``device``: the caller's process
    group when one is initialised (left as it is), else a one-rank group
    over an in-process store, started here and destroyed when the scope
    ends, on every exit."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    dist.init_process_group(group_backend(device), store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
