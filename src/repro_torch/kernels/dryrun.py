"""The dry run's switch for the LM kernels' wrappers.

A wrapper (``flash_attention``, ``ssd``, their backwards,
``decode_attention`` and the Mamba2 ``mixer``) takes its route from its
tensors' device: CUDA → the kernel's custom operator, CPU → the plain
version.  A dry run traces with fake tensors whose device says nothing
about the card (the dry run lays its meshes out on the CPU), so it asks
for the custom operators explicitly: inside :func:`dry_run` every wrapper
calls its operator, whose fake implementation gives the kernel's outputs
and saved tensors and whose FLOP rule the dry run counts.  The plain
forwards (the dense S x S attention among them) are never taken there;
the Mamba2 mix kernels' backward recomputes their plain version, there as
on the card.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["dry_run", "active"]

_state = threading.local()


@contextlib.contextmanager
def dry_run():
    prev = active()
    _state.on = True
    try:
        yield
    finally:
        _state.on = prev


def active() -> bool:
    return getattr(_state, "on", False)
