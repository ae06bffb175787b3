"""Production meshes and the hardware model of the roofline.

Counterpart of the reference's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over a process group.  The
production meshes keep the reference's shapes and axis names, ``(16, 16)``
``("data", "model")`` and ``(2, 16, 16)`` ``("pod", "data", "model")``, so
that partitioning compares one to one; on H100 nodes of 8 cards a 16-wide
``model`` axis spans two nodes, which :mod:`repro_torch.launch.roofline`
accounts for.

The dry run has no cluster: inside :func:`fake_world` a mesh made over no
process group gets a fake one of its size (PyTorch's ``"fake"`` backend,
whose collectives move nothing), destroyed when the scope ends.  Kept as
functions, never module-level constants, so importing this module touches
no device or process-group state.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import group_backend

__all__ = ["HW", "fake_world", "make_mesh", "make_production_mesh",
           "make_local_mesh"]

_state = threading.local()


class HW:
    """NVIDIA H100 SXM5 constants for the roofline model (NVIDIA's data
    sheet, dense rates at the 700 W power limit)."""

    PEAK_FLOPS_BF16 = 989e12   # per card
    HBM_BW = 3.35e12           # bytes/s per card (HBM3)
    # torch.cuda.get_device_properties(0).total_memory on an
    # NVIDIA H100 80GB HBM3 (chip_smoke.py phase 16 prints it)
    HBM_BYTES = 85_017_493_504
    CARDS_PER_NODE = 8
    NVLINK_BW = 450e9          # bytes/s per card and direction (NVLink 4)
    IB_BW = 50e9               # bytes/s per card between nodes (NDR 400G)


@contextlib.contextmanager
def fake_world():
    """Scope of a dry run: :func:`make_mesh` over no process group starts a
    fake one of the mesh's size, and the scope's end destroys it."""
    prev = getattr(_state, "fake_ok", False)
    _state.fake_ok = True
    try:
        yield
    finally:
        _state.fake_ok = prev
        if dist.is_initialized() and dist.get_backend() == "fake":
            dist.destroy_process_group()


def _ensure_world(n: int) -> None:
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a mesh of {n} devices over a process group "
                             f"of {dist.get_world_size()}")
        return
    if not getattr(_state, "fake_ok", False):
        raise RuntimeError(
            "no process group: initialise one (torch.distributed), or make "
            "the mesh inside launch.mesh.fake_world() for a dry run")
    # registers PyTorch's "fake" backend (shipped with torch)
    import torch.testing._internal.distributed.fake_pg as fake_pg
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=n)


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` with axis ``names`` over the whole process group
    (a fake one inside :func:`fake_world` when there is none)."""
    n = math.prod(shape)
    _ensure_world(n)
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: (16, 16) ("data", "model"); two pods: (2, 16, 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(device_type: str = "cpu") -> DeviceMesh:
    """The world the process runs in as a ``(world, 1)`` ("data", "model")
    mesh of ``device_type`` devices: a ``(1, 1)`` mesh of one process when
    no process group is up (then a one-rank group over a local store is
    started, whose backend reduces ``device_type`` tensors; the caller
    destroys it, or makes the mesh inside ``device.process_world``)."""
    if not dist.is_initialized() and not getattr(_state, "fake_ok", False):
        dist.init_process_group(group_backend(device_type),
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n, 1), ("data", "model"), device_type)
