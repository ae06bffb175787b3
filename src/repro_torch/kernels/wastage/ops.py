"""Wrappers of the wastage kernels: group tables, checks, routing and launch
counts.

Every entry of ``csrc/wastage.cu`` runs over a :class:`GroupTable`: one
record per (plan batch, trace bucket) :class:`Group`, so one launch covers a
whole fleet call.  :func:`oom_probe` and :func:`wastage_eval` keep their
one-group signatures; :func:`oom_probe_groups`, :func:`wastage_eval_groups`
and :func:`fleet_engine` take a table.

A table on the CPU goes to the plain PyTorch versions in
:mod:`repro_torch.kernels.wastage.ref` (``plain_engine`` for the engine); a
table on CUDA goes to the hand-written kernel or raises — there is no
fallback.  Each op
keeps a plain integer count in :data:`LAUNCHES`, bumped only where its
kernel is launched, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.wastage import ref

__all__ = ["LAUNCHES", "SOURCE", "RETRY_KINDS", "Group", "GroupTable",
           "reset_launches", "oom_probe", "wastage_eval", "oom_probe_groups",
           "wastage_eval_groups", "fleet_engine"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "wastage.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (table, n_groups, n_lanes, dt, [mm, max_attempts,] out,
# stream)
SIGNATURES = {
    "ksp_oom_probe": [_P, _I, _I, _F, _P, _P],
    "ksp_wastage_eval": [_P, _I, _I, _F, _P, _P],
    "ksp_fleet_engine": [_P, _I, _I, _F, _F, _I, _P, _P],
}

LAUNCHES = {"oom_probe": 0, "wastage_eval": 0, "fleet_engine": 0}
MAX_K = 32  # kMaxK in csrc/wastage.cu
# the retry rules, numbered as Kind in csrc/wastage.cu
RETRY_KINDS = ("none", "double", "max-machine", "kseg-selective",
               "kseg-partial", "ksplus")
# struct Group in csrc/wastage.cu: seven pointers, then eight 4-byte fields
GROUP_DTYPE = np.dtype([
    ("starts", "<u8"), ("peaks", "<u8"), ("nseg", "<u8"), ("bump", "<u8"),
    ("mems", "<u8"), ("lengths", "<u8"), ("summem", "<u8"),
    ("B", "<i4"), ("K", "<i4"), ("T", "<i4"), ("lane0", "<i4"),
    ("kind", "<i4"), ("margin", "<f4"), ("bump_mul", "<f4"), ("vec", "<i4")])
assert GROUP_DTYPE.itemsize == 88
_PLAN_FIELDS = (("starts", torch.float32), ("peaks", torch.float32),
                ("nseg", torch.int32), ("bump_lanes", torch.float32))
_NP = {torch.float32: np.dtype(np.float32), torch.int32: np.dtype(np.int32)}
_ALIGN = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Group:
    """One (plan batch, trace bucket) group: lane ``l`` runs the plan
    ``(starts[l], peaks[l])`` (``(B, K)`` float32) over row ``l`` of
    ``mems`` (``(R, T)`` float32, ``R >= B``) with ``lengths[l]`` valid
    samples (``(R,)`` int32).

    The plan arrays may be numpy arrays (a :class:`GroupTable` uploads
    them) or tensors on the table's device; ``mems``, ``lengths`` and
    ``summem`` are tensors.  Only :func:`fleet_engine` reads ``nseg``
    (``(B,)`` int32 real slots), ``summem`` (``(R,)`` float32 sum of each
    row's valid samples), the retry rule ``kind`` / ``margin`` / ``bump``
    and the optional per-lane ksplus bump ``bump_lanes`` (``(B,)``
    float32).
    """

    starts: object
    peaks: object
    mems: torch.Tensor
    lengths: torch.Tensor
    nseg: object = None
    summem: Optional[torch.Tensor] = None
    bump_lanes: object = None
    kind: str = "none"
    margin: float = 0.10
    bump: float = 0.20

    @property
    def B(self) -> int:
        return int(self.starts.shape[0])

    @property
    def K(self) -> int:
        return int(self.starts.shape[1])


def _check_group(g: Group, device: torch.device) -> None:
    """The kernel contract for one group; raise on what it does not take."""
    B, K = g.starts.shape if g.starts.ndim == 2 else (-1, -1)
    if K < 1 or tuple(g.peaks.shape) != (B, K):
        raise ValueError(f"starts {tuple(g.starts.shape)} and peaks "
                         f"{tuple(g.peaks.shape)} must be one (B, K), K >= 1")
    if g.mems.dim() != 2 or g.mems.shape[0] < B or g.mems.shape[1] < 1 \
            or tuple(g.lengths.shape) != (g.mems.shape[0],):
        raise ValueError(f"mems {tuple(g.mems.shape)} must be (R >= {B}, T)"
                         f" and lengths {tuple(g.lengths.shape)} (R,)")
    if device.type == "cuda" and K > MAX_K:
        raise ValueError(f"the kernel takes K <= {MAX_K}, got {K}")
    if g.kind not in RETRY_KINDS:
        raise ValueError(f"unknown retry kind: {g.kind!r}")
    arrays = [("starts", g.starts, torch.float32), ("peaks", g.peaks,
                                                    torch.float32),
              ("mems", g.mems, torch.float32),
              ("lengths", g.lengths, torch.int32)]
    if g.nseg is not None:
        arrays.append(("nseg", g.nseg, torch.int32))
    if g.bump_lanes is not None:
        arrays.append(("bump_lanes", g.bump_lanes, torch.float32))
    if g.summem is not None:
        arrays.append(("summem", g.summem, torch.float32))
    for name, x, dtype in arrays:
        if isinstance(x, np.ndarray):
            if name in ("mems", "lengths", "summem"):
                raise TypeError(f"{name} must be a torch.Tensor")
            if x.dtype != _NP[dtype]:
                raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
            continue
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor or numpy array")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the table on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("nseg", "bump_lanes"):
        x = getattr(g, name)
        if x is not None and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(x.shape)}")
    if g.summem is not None and tuple(g.summem.shape) != (g.mems.shape[0],):
        raise ValueError(f"summem must be ({g.mems.shape[0]},)")


def _nondecreasing(starts) -> bool:
    """Whether every lane's starts never decrease (a NaN counts as a
    decrease); a read of the device for a CUDA tensor."""
    if isinstance(starts, np.ndarray):
        return bool(np.all(starts[:, 1:] >= starts[:, :-1]))
    return bool((starts[:, 1:] >= starts[:, :-1]).all())


def table_layout(groups: Sequence[Group]):
    """Where a table's bytes go: the records first, then every plan array
    given as numpy, each 16-byte aligned.  Returns ``(places, nbytes)``
    with ``places[g]`` mapping each such field to its byte offset."""
    off = len(groups) * GROUP_DTYPE.itemsize
    places = []
    for g in groups:
        place = {}
        for name, _ in _PLAN_FIELDS:
            x = getattr(g, name)
            if isinstance(x, np.ndarray):
                off = -(-off // _ALIGN) * _ALIGN
                place[name] = off
                off += x.nbytes
        places.append(place)
    return places, off


def table_image(groups: Sequence[Group], places, nbytes: int,
                base: int) -> np.ndarray:
    """The table's bytes for a device buffer at address ``base``: one
    record per group (first lanes in order, pointers to the uploaded plan
    arrays or to the tensors' own storage, 0 for a field not given), then
    the plan arrays at their places."""
    image = np.zeros((nbytes,), np.uint8)
    rec = np.zeros((len(groups),), GROUP_DTYPE)
    lane0 = 0
    for i, (g, place) in enumerate(zip(groups, places)):
        r = rec[i:i + 1]
        for name in ("starts", "peaks", "nseg", "bump_lanes", "mems",
                     "lengths", "summem"):
            x = getattr(g, name)
            field = "bump" if name == "bump_lanes" else name
            if x is None:
                r[field] = 0
            elif isinstance(x, np.ndarray):
                r[field] = base + place[name]
                image[place[name]:place[name] + x.nbytes] = \
                    np.ascontiguousarray(x).view(np.uint8).ravel()
            else:
                r[field] = x.data_ptr()
        T = int(g.mems.shape[1])
        r["B"], r["K"], r["T"], r["lane0"] = g.B, g.K, T, lane0
        r["kind"] = RETRY_KINDS.index(g.kind)
        # Python's float, rounded to float32 as PyTorch rounds a scalar
        r["margin"] = np.float32(1.0 + g.margin)
        r["bump_mul"] = np.float32(1.0 + g.bump)
        r["vec"] = int(T % 4 == 0 and g.mems.data_ptr() % 16 == 0)
        lane0 += g.B
    image[:rec.nbytes] = rec.view(np.uint8)
    return image


class GroupTable:
    """Groups laid out for one launch on ``device``.

    On CUDA the records and every plan array given as numpy go up in ONE
    host-to-device copy into :attr:`buf`.  :attr:`groups` holds each group
    with all its arrays as tensors on ``device`` (views of :attr:`buf` for
    the uploaded ones), so the plain versions run on exactly what the
    kernel reads; group ``g`` owns lanes ``lane0[g]:lane0[g + 1]`` of every
    flat output.  The kernel's warps take lanes in table order, so a table
    that lists its longest rows first finishes soonest.
    :attr:`nondecreasing` holds, per group given numpy starts, whether its
    lanes' starts never decrease (None for starts given as a tensor).
    """

    def __init__(self, groups: Sequence[Group], device):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        groups = list(groups)
        if not groups:
            raise ValueError("a group table needs at least one group")
        for g in groups:
            _check_group(g, self.device)
        self.nondecreasing = tuple(
            _nondecreasing(g.starts) if isinstance(g.starts, np.ndarray)
            else None for g in groups)
        self.lane0 = np.cumsum([0] + [g.B for g in groups])
        self.n_lanes = int(self.lane0[-1])
        self.buf = None
        places, nbytes = table_layout(groups)
        if self.device.type == "cuda":
            self.buf = torch.empty((nbytes,), dtype=torch.uint8,
                                   device=self.device)
            image = table_image(groups, places, nbytes, self.buf.data_ptr())
            self.buf.copy_(torch.from_numpy(image))
        self.groups = tuple(
            dataclasses.replace(g, **{
                name: self._tensor(getattr(g, name), dtype, place.get(name))
                for name, dtype in _PLAN_FIELDS
                if isinstance(getattr(g, name), np.ndarray)})
            for g, place in zip(groups, places))

    def _tensor(self, x: np.ndarray, dtype, off):
        if self.buf is None:
            return torch.from_numpy(np.ascontiguousarray(x))
        return self.buf[off:off + x.nbytes].view(dtype).view(x.shape)

    def __len__(self) -> int:
        return len(self.groups)


def _launch(op: str, table: GroupTable, *args) -> torch.Tensor:
    """Call ``ksp_<op>`` over ``table`` on its device's current stream;
    returns the ``(3, n_lanes)`` int32 output words."""
    out = torch.empty((3, table.n_lanes), dtype=torch.int32,
                      device=table.device)
    build.launch(build.load(SOURCE, SIGNATURES), f"ksp_{op}", table.device,
                 table.buf.data_ptr(), len(table), table.n_lanes, *args,
                 out.data_ptr())
    LAUNCHES[op] += 1
    return out


def _rows(g: Group):
    return g.mems[:g.B], g.lengths[:g.B]


def oom_probe_groups(table: GroupTable, dt: float = 1.0):
    """One OOM attempt for every lane of every group, one launch:
    ``(viol int32, w_succ f32, w_kill f32)``, each ``(n_lanes,)``."""
    if table.device.type == "cpu":
        outs = [ref.oom_probe(g.starts, g.peaks, *_rows(g), dt)
                for g in table.groups]
        return tuple(torch.cat(x) for x in zip(*outs))
    if table.n_lanes == 0:
        return (torch.empty((0,), dtype=torch.int32, device=table.device),
                *(torch.empty((0,), device=table.device),) * 2)
    out = _launch("oom_probe", table, float(dt))
    return out[0], out[1].view(torch.float32), out[2].view(torch.float32)


def wastage_eval_groups(table: GroupTable, dt: float = 1.0):
    """Success wastage of every lane of every group, one launch:
    ``(n_lanes,)`` float32; takes non-monotone plans."""
    if table.device.type == "cpu":
        return torch.cat([ref.wastage_eval(g.starts, g.peaks, *_rows(g), dt)
                          for g in table.groups])
    if table.n_lanes == 0:
        return torch.empty((0,), device=table.device)
    return _launch("wastage_eval", table, float(dt))[0].view(torch.float32)


def fleet_engine(table: GroupTable, machine_memory: float, dt: float,
                 max_attempts: int) -> torch.Tensor:
    """The whole OOM/retry protocol for every lane of every group.

    Each group needs ``nseg``, ``summem`` and non-decreasing starts in
    every lane (the kernel walks each sample forward to its slot; every
    plan the engine builds has them, and its retry rules keep them), else
    this raises.  Starts given as numpy are checked on the host before the
    upload; starts given as a CUDA tensor cost one read of the device.
    Returns the ``(3, n_lanes)`` int32 words ``[wastage (float32 bits),
    attempts, succeeded]``, so a caller reads all three with one host copy.
    On CUDA one launch runs every attempt; on the CPU
    :func:`repro_torch.kernels.wastage.ref.plain_engine`.
    """
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    for i, (g, ok) in enumerate(zip(table.groups, table.nondecreasing)):
        if g.nseg is None or g.summem is None:
            raise ValueError("fleet_engine needs nseg and summem per group")
        if not (_nondecreasing(g.starts) if ok is None else ok):
            raise ValueError(f"group {i}: fleet_engine needs plan starts "
                             "that are non-decreasing in every lane")
    if table.device.type == "cpu":
        return ref.plain_engine(table, machine_memory, dt, max_attempts)
    if table.n_lanes == 0:
        return torch.empty((3, 0), dtype=torch.int32, device=table.device)
    return _launch("fleet_engine", table, float(dt),
                   float(np.float32(machine_memory)), int(max_attempts))


def _one_group(starts, peaks, mems, lengths) -> GroupTable:
    """A table of one group over ``(B, T)`` rows, checked as any group."""
    for name, x in (("starts", starts), ("peaks", peaks), ("mems", mems),
                    ("lengths", lengths)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if mems.dim() != 2 or starts.dim() != 2 \
            or mems.shape[0] != starts.shape[0]:
        raise ValueError(f"starts {tuple(starts.shape)} must be (B, K) over "
                         f"mems {tuple(mems.shape)} (B, T)")
    return GroupTable([Group(starts, peaks, mems, lengths)], mems.device)


def oom_probe(starts, peaks, mems, lengths, dt: float = 1.0):
    """One OOM attempt per lane: ``(viol int32, w_succ f32, w_kill f32)``.

    starts/peaks: (B, K) float32; mems: (B, T) float32; lengths: (B,) int32,
    all contiguous on one device.  A table of one group.
    """
    return oom_probe_groups(_one_group(starts, peaks, mems, lengths), dt)


def wastage_eval(starts, peaks, mems, lengths, dt: float = 1.0):
    """Success wastage per lane, (B,) float32; takes non-monotone plans."""
    return wastage_eval_groups(_one_group(starts, peaks, mems, lengths), dt)
