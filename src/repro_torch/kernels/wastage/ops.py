"""Wrappers of the wastage kernels: checks, routing and launch counts.

A tensor on the CPU goes to the plain PyTorch version
(:mod:`repro_torch.kernels.wastage.ref`); a tensor on CUDA goes to the
hand-written kernel (``csrc/wastage.cu``) or raises — there is no fallback.
Each op keeps a plain integer count in :data:`LAUNCHES`, bumped only where
its kernel is launched, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wastage import ref

__all__ = ["LAUNCHES", "reset_launches", "oom_probe", "wastage_eval"]

LAUNCHES = {"oom_probe": 0, "wastage_eval": 0}
MAX_K = 32  # kMaxK in csrc/wastage.cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(starts, peaks, mems, lengths):
    """Validate the kernel contract; return ``(B, K, T)``."""
    for name, x, dtype in (("starts", starts, torch.float32),
                           ("peaks", peaks, torch.float32),
                           ("mems", mems, torch.float32),
                           ("lengths", lengths, torch.int32)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != mems.device:
            raise ValueError(f"{name} is on {x.device}, mems on {mems.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mems.dim() != 2 or starts.dim() != 2:
        raise ValueError("starts/peaks must be (B, K) and mems (B, T)")
    B, T = mems.shape
    K = starts.shape[1]
    if starts.shape != (B, K) or peaks.shape != (B, K) \
            or lengths.shape != (B,):
        raise ValueError(
            f"shapes starts {tuple(starts.shape)} peaks {tuple(peaks.shape)} "
            f"mems {tuple(mems.shape)} lengths {tuple(lengths.shape)}")
    if K < 1 or T < 1:
        raise ValueError(f"need K >= 1 and T >= 1, got K={K} T={T}")
    if mems.device.type == "cuda" and K > MAX_K:
        raise ValueError(f"the kernel takes K <= {MAX_K}, got {K}")
    if mems.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mems.device}")
    return B, K, T


def _launch(op: str, device: torch.device, *args) -> None:
    """Call the C entry point ``ksp_<op>`` on ``device``'s current stream."""
    from repro_torch.kernels.wastage.build import load
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(load(), f"ksp_{op}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{op}: kernel launch failed, cudaError {rc}")
    LAUNCHES[op] += 1


def oom_probe(starts, peaks, mems, lengths, dt: float = 1.0):
    """One OOM attempt per lane: ``(viol int32, w_succ f32, w_kill f32)``.

    starts/peaks: (B, K) float32; mems: (B, T) float32; lengths: (B,) int32,
    all contiguous on one device.
    """
    B, K, T = _check(starts, peaks, mems, lengths)
    if mems.device.type == "cpu":
        return ref.oom_probe(starts, peaks, mems, lengths, dt)
    viol = torch.empty((B,), dtype=torch.int32, device=mems.device)
    w_succ = torch.empty((B,), dtype=torch.float32, device=mems.device)
    w_kill = torch.empty((B,), dtype=torch.float32, device=mems.device)
    if B == 0:
        return viol, w_succ, w_kill
    _launch("oom_probe", mems.device, starts.data_ptr(), peaks.data_ptr(),
            mems.data_ptr(), lengths.data_ptr(), B, K, T, float(dt),
            viol.data_ptr(), w_succ.data_ptr(), w_kill.data_ptr())
    return viol, w_succ, w_kill


def wastage_eval(starts, peaks, mems, lengths, dt: float = 1.0):
    """Success wastage per lane, (B,) float32; takes non-monotone plans."""
    B, K, T = _check(starts, peaks, mems, lengths)
    if mems.device.type == "cpu":
        return ref.wastage_eval(starts, peaks, mems, lengths, dt)
    w_succ = torch.empty((B,), dtype=torch.float32, device=mems.device)
    if B == 0:
        return w_succ
    _launch("wastage_eval", mems.device, starts.data_ptr(),
            peaks.data_ptr(), mems.data_ptr(), lengths.data_ptr(), B, K, T,
            float(dt), w_succ.data_ptr())
    return w_succ
