"""Wrappers of the admission kernels: checks, routing and launch counts.

:func:`admit_columns` and :func:`admit_drain` take the packed lane state of
:class:`repro_torch.sched.admission.AdmissionState` (``starts`` / ``peaks``
``(B, K)``, ``admit_t`` ``(B + 1,)``, ``dur`` ``(B,)``, ``need`` / ``grid``
``(B, G)``) and one call's operands (``caps`` ``(N,)``, ``run_idx`` and
``run_valid`` ``(N, R)``, the queued lanes ``q_idx`` ``(Q,)``, ``now`` and
``tol`` as 0-d tensors), in the argument order of the reference's jitted
programs.  Floats are float64 and indices int64, all contiguous on one
device.  Tensors on the CPU go to the plain versions in
:mod:`repro_torch.kernels.admission.ref`; tensors on CUDA go to the
kernels of ``csrc/admission.cu`` or raise — there is no fallback.  Each op
keeps a plain integer count in :data:`LAUNCHES`, bumped only where its
kernel is launched.  The indices are the caller's contract: every
``run_idx`` and ``q_idx`` entry names a lane below ``B``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.admission import ref

__all__ = ["LAUNCHES", "SOURCE", "MAX_QUEUE", "reset_launches",
           "admit_columns", "admit_drain"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "admission.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: the ten operand pointers (starts, peaks, admit_t, dur,
# need, grid, caps, run_idx, run_valid, q_idx), now, tol, then N, R, Q, K,
# G, masked, [B, select, scratch,] the output, the stream
SIGNATURES = {
    "ksp_admit_columns": [_P] * 12 + [_I] * 6 + [_P, _P],
    "ksp_admit_drain": [_P] * 12 + [_I] * 8 + [_P, _P, _P],
}
LAUNCHES = {"admit_columns": 0, "admit_drain": 0}
MAX_QUEUE = 1024   # kDrainThreads in csrc/admission.cu: a thread a lane
SELECTS = ("first", "headroom")

_scratch: dict = {}  # device -> the drain's scratch (float64 words)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(starts, peaks, admit_t, dur, need, grid, caps, run_idx,
           run_valid, q_idx, now, tol) -> torch.device:
    """The kernels' contract; returns the tensors' device."""
    f64 = dict(starts=starts, peaks=peaks, admit_t=admit_t, dur=dur,
               need=need, grid=grid, caps=caps, now=now, tol=tol)
    i64 = dict(run_idx=run_idx, run_valid=run_valid, q_idx=q_idx)
    device = starts.device
    for name, x in {**f64, **i64}.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        want = torch.float64 if name in f64 else torch.int64
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, starts on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if starts.dim() != 2 or starts.shape[1] < 1 \
            or peaks.shape != starts.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and peaks "
                         f"{tuple(peaks.shape)} must be one (B, K), K >= 1")
    B = starts.shape[0]
    if need.dim() != 2 or need.shape[0] != B or need.shape[1] < 1 \
            or grid.shape != need.shape:
        raise ValueError(f"need {tuple(need.shape)} and grid "
                         f"{tuple(grid.shape)} must be one ({B}, G), G >= 1")
    if tuple(admit_t.shape) != (B + 1,) or tuple(dur.shape) != (B,):
        raise ValueError(f"admit_t {tuple(admit_t.shape)} must be ({B + 1},)"
                         f" and dur {tuple(dur.shape)} ({B},)")
    if run_idx.dim() != 2 or min(run_idx.shape) < 1 \
            or run_valid.shape != run_idx.shape \
            or tuple(caps.shape) != (run_idx.shape[0],):
        raise ValueError(f"run_idx {tuple(run_idx.shape)} and run_valid "
                         f"{tuple(run_valid.shape)} must be one (N, R >= 1)"
                         f" over caps {tuple(caps.shape)} (N,)")
    if q_idx.dim() != 1 or q_idx.shape[0] < 1:
        raise ValueError(f"q_idx must be (Q >= 1,), got {tuple(q_idx.shape)}")
    if now.dim() != 0 or tol.dim() != 0:
        raise ValueError("now and tol must be 0-d tensors")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _args(starts, peaks, admit_t, dur, need, grid, caps, run_idx,
          run_valid, q_idx, now, tol, masked):
    """The pointers and sizes every C entry takes first."""
    N, R = run_idx.shape
    return ([x.data_ptr() for x in (starts, peaks, admit_t, dur, need, grid,
                                    caps, run_idx, run_valid, q_idx, now,
                                    tol)]
            + [N, R, q_idx.shape[0], starts.shape[1], grid.shape[1],
               int(bool(masked))])


def admit_columns(starts, peaks, admit_t, dur, need, grid, caps, run_idx,
                  run_valid, q_idx, now, tol, masked: bool) -> torch.Tensor:
    """Fits and minimum residual of every (node, queued lane): ``(2, N, Q)``
    float64, ``fits`` as 1.0 / 0.0, then ``minresid`` (the reference's
    ``_fused_kernel``).  One launch on CUDA."""
    ops = (starts, peaks, admit_t, dur, need, grid, caps, run_idx,
           run_valid, q_idx, now, tol)
    device = _check(*ops)
    if device.type == "cpu":
        return ref.plain_columns(*ops, masked)
    out = torch.empty((2, run_idx.shape[0], q_idx.shape[0]),
                      dtype=torch.float64, device=device)
    build.launch(build.load(SOURCE, SIGNATURES), "ksp_admit_columns", device,
                 *_args(*ops, masked), out.data_ptr())
    LAUNCHES["admit_columns"] += 1
    return out


def _drain_scratch(device: torch.device, N: int, Q: int,
                   G: int) -> torch.Tensor:
    """The drain's scratch on ``device``: the ``(N, Q, G)`` float64
    residual, an int a node and an ``(N, Q)`` byte fit table, in float64
    words.  Kept between launches (grown, never shrunk); launches on one
    stream reuse it in order."""
    n = N * Q * G + (4 * N + N * Q + 7) // 8
    kept = _scratch.get(device)
    # lint: allow[host-sync-in-hot-path] numel() is host metadata, no read
    if kept is None or kept.numel() < n:
        kept = _scratch[device] = torch.empty((n,), dtype=torch.float64,
                                              device=device)
    return kept


def admit_drain(starts, peaks, admit_t, dur, need, grid, caps, run_idx,
                run_valid, q_idx, now, tol, masked: bool,
                select: str) -> tuple:
    """The whole greedy drain over ``q_idx`` (queue order), the reference's
    ``_drain_kernel``: returns the ``(2 + 2Q,)`` int64 vector ``[count,
    iterations, lanes[Q], nodes[Q]]`` (slots past ``count`` hold ``B``)
    and the number of host reads the route takes to bring the drain to the
    host, and writes ``now`` into ``admit_t`` at every placed lane and at
    the spare slot ``B``.  On CUDA one launch of one block, ``Q <=
    MAX_QUEUE`` and any ``N`` the scratch holds; its one read is the
    caller's read of the vector.  The plain loop on the CPU reads its done
    flag once an iteration and leaves the vector on the host."""
    ops = (starts, peaks, admit_t, dur, need, grid, caps, run_idx,
           run_valid, q_idx, now, tol)
    device = _check(*ops)
    if select not in SELECTS:
        raise ValueError(f"unknown drain select rule: {select!r}")
    if device.type == "cpu":
        vec = ref.plain_drain(*ops, masked, select)
        # lint: allow[host-sync-in-hot-path] a CPU tensor: no device read
        return vec, int(vec[1])
    N, Q, G = run_idx.shape[0], q_idx.shape[0], grid.shape[1]
    if Q > MAX_QUEUE:
        raise ValueError(f"the drain kernel takes Q <= {MAX_QUEUE} lanes, "
                         f"got Q = {Q}")
    scratch = _drain_scratch(device, N, Q, G)
    out = torch.empty((2 + 2 * Q,), dtype=torch.int64, device=device)
    build.launch(build.load(SOURCE, SIGNATURES), "ksp_admit_drain", device,
                 *_args(*ops, masked), starts.shape[0],
                 SELECTS.index(select), scratch.data_ptr(), out.data_ptr())
    LAUNCHES["admit_drain"] += 1
    return out, 1
