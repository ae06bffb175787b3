"""Plain PyTorch versions of the wastage kernels.

They compute exactly what the TPU kernels computed
(``repro/kernels/wastage/kernel.py``): the step-function allocation comes
from the one-hot interval select of ``_alloc_block`` — slot ``k`` is active
on ``[starts_k, starts_{k+1})``, so duplicate starts give empty intervals,
the last ``start <= t`` wins, sentinel slots never activate, and a sample
with no active slot reads ``peaks[0]`` — on the float32 grid
``t = float32(i) * float32(dt)``.  The CUDA kernel (``csrc/wastage.cu``)
runs the same select slot by slot in the same order, so the two agree
bitwise on ``viol`` and on the allocation; only the sums' order differs.

The wrappers in :mod:`repro_torch.kernels.wastage.ops` call these for a
tensor on the CPU; ``chip_smoke.py`` holds the kernel against them on the
card.
"""

from __future__ import annotations

import torch

__all__ = ["alloc_grid", "oom_probe", "wastage_eval"]


def alloc_grid(starts: torch.Tensor, peaks: torch.Tensor, T: int,
               dt: float) -> torch.Tensor:
    """``(B, T)`` float32 allocation by one-hot interval select."""
    B, K = starts.shape
    t = torch.arange(T, dtype=torch.float32, device=starts.device) * dt
    t = t[None, :]
    acc = torch.zeros((B, T), dtype=torch.float32, device=starts.device)
    hit = torch.zeros((B, T), dtype=torch.bool, device=starts.device)
    for k in range(K):
        in_seg = starts[:, k:k + 1] <= t
        if k + 1 < K:
            in_seg = in_seg & (t < starts[:, k + 1:k + 2])
        acc = acc + torch.where(in_seg, peaks[:, k:k + 1], 0.0)
        hit = hit | in_seg
    return torch.where(hit, acc, peaks[:, :1])


def oom_probe(starts, peaks, mems, lengths, dt: float):
    """One OOM attempt per lane: ``(viol, w_succ, w_kill)``.

    ``viol`` (int32) is the first valid sample with ``mem > alloc`` or -1;
    ``w_succ = Σ (max(alloc, mem) − mem) · dt`` over valid samples;
    ``w_kill = Σ_{i ≤ viol} alloc · dt``, 0 where there is no violation.
    """
    B, T = mems.shape
    alloc = alloc_grid(starts, peaks, T, dt)
    i = torch.arange(T, device=mems.device)[None, :]
    valid = i < lengths[:, None]
    bad = (mems > alloc) & valid
    first = torch.where(bad, i, T).amin(dim=1)
    found = first < T
    viol = torch.where(found, first, -1).to(torch.int32)
    w_succ = torch.where(valid, torch.maximum(alloc, mems) - mems,
                         0.0).sum(dim=1) * dt
    w_kill = torch.where(valid & (i <= first[:, None]), alloc,
                         0.0).sum(dim=1) * dt
    return viol, w_succ, torch.where(found, w_kill, 0.0)


def wastage_eval(starts, peaks, mems, lengths, dt: float):
    """Success wastage only: ``Σ (max(alloc, mem) − mem) · valid · dt``."""
    B, T = mems.shape
    alloc = alloc_grid(starts, peaks, T, dt)
    valid = torch.arange(T, device=mems.device)[None, :] < lengths[:, None]
    return torch.where(valid, torch.maximum(alloc, mems) - mems,
                       0.0).sum(dim=1) * dt
