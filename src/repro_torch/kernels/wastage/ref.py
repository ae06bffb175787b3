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

:func:`plain_engine` is the plain version of the ``fleet_engine`` kernel:
the whole OOM/retry protocol over a group table, as the reference engine
runs it (``repro/core/fleet.py``), in float32 on the same grid, with the
retry rules of ``core.retry`` as tensor plan rewrites.

The wrappers in :mod:`repro_torch.kernels.wastage.ops` call these for a
tensor on the CPU; ``tests/test_torch_kernels_card.py`` and
``tests/test_torch_fleet_engine_card.py`` hold the kernels against them on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["alloc_grid", "oom_probe", "wastage_eval", "plain_engine"]

_F32 = torch.float32
_I32_MAX = np.iinfo(np.int32).max
# start of a padded plan slot: core.envelope.PAD_START, kPadStart in
# csrc/wastage.cu
PAD_START = 1e30


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


# ------------------------------------------------- the engine: its probe
def _alloc_on_grid(starts, peaks, T: int, dt: float):
    """``alloc(t) = peaks[#{i : starts_i <= t} - 1]`` on the float32 grid.

    Reproduces the oracle's ``searchsorted(side='right') - 1`` lookup,
    duplicate starts and sentinel padding included; counted slot by slot so
    the work stays (B, T), not (B, T, K).
    """
    B, K = starts.shape
    t = (torch.arange(T, dtype=_F32, device=starts.device) * dt)[None, :]
    cnt = torch.zeros((B, T), dtype=torch.int64, device=starts.device)
    for k in range(K):
        cnt += starts[:, k:k + 1] <= t
    return torch.gather(peaks, 1, (cnt - 1).clamp_(0, K - 1))


def _first_violation(starts, peaks, memsneg, dt: float):
    """First sample with ``mem > alloc`` per lane, or -1 (int32).

    ``memsneg`` is -inf outside the valid span, folding the validity mask
    into the comparison itself.
    """
    B, T = memsneg.shape
    bad = memsneg > _alloc_on_grid(starts, peaks, T, dt)
    i = torch.arange(T, device=memsneg.device)[None, :]
    first = torch.where(bad, i, T).amin(dim=1)
    return torch.where(first < T, first, -1).to(torch.int32)


def _seg_bounds(starts, dt: float):
    """b_k = first sample index i with ``i*dt >= starts_k`` — exactly.

    ``ceil(start/dt)`` alone can be off by one ulp, so both neighbours are
    checked with the *same* float32 arithmetic the probe's time grid uses
    (``float32(i) * dt``), making the boundaries bit-consistent with the
    per-sample comparisons.
    """
    c = torch.clamp(torch.ceil(starts / dt), 0.0, 1.0e9)
    c = c - ((c - 1.0) * dt >= starts).to(_F32)
    c = c + (torch.clamp(c, 0.0, 1.0e9) * dt < starts).to(_F32)
    b = torch.clamp(c, 0.0, 2.0e9).to(torch.int32)
    # segment 0 is active from t=0 regardless (index clipping semantics)
    b[:, 0] = 0
    return b


def _span_alloc_sum(peaks, bounds, upto):
    """``sum_k peaks_k * |[b_k, b_{k+1}) ∩ [0, upto)|`` — the allocation
    integral over the first ``upto`` samples in O(K) per lane.

    Summed slot by slot in order, so padded slots (span 0) leave the sum
    bit-identical whatever K a batch was padded to.
    """
    B, K = peaks.shape
    hi = torch.cat([bounds[:, 1:],
                    torch.full((B, 1), _I32_MAX, dtype=torch.int32,
                               device=bounds.device)], dim=1)
    lo = torch.minimum(bounds, upto[:, None])
    hi = torch.minimum(hi, upto[:, None])
    span = (hi - lo).clamp_(min=0).to(_F32)
    acc = peaks[:, 0] * span[:, 0]
    for k in range(1, K):
        acc = acc + peaks[:, k] * span[:, k]
    return acc


def _probe_first(starts, peaks, memsneg, lengths, summem, dt: float):
    """Attempt-#1 probe: ``(viol, w_succ)`` with w_succ valid where viol<0.

    For a successful attempt ``max(alloc, mem) == alloc`` everywhere, so the
    wastage integral collapses to segment-span arithmetic minus ``summem``.
    """
    viol = _first_violation(starts, peaks, memsneg, dt)
    bounds = _seg_bounds(starts, dt)
    w_succ = (_span_alloc_sum(peaks, bounds, lengths) - summem) * dt
    return viol, w_succ, bounds


def _oom_probe_torch(starts, peaks, mems, memsneg, lengths, summem,
                     dt: float):
    """Full per-attempt probe: ``(viol, w_succ, w_kill, used)``.

    ``w_succ`` is exact only for lanes with ``viol < 0`` (the engine never
    reads it otherwise); ``w_kill`` integrates the allocation up to and
    including the kill sample, again in O(K) spans.
    """
    viol, w_succ, bounds = _probe_first(starts, peaks, memsneg, lengths,
                                        summem, dt)
    v = viol.clamp(min=0)
    w_kill = torch.where(
        viol >= 0, _span_alloc_sum(peaks, bounds, v + 1), 0.0) * dt
    used = torch.gather(mems, 1, v[:, None].long())[:, 0]
    return viol, w_succ, w_kill, used


# --------------------------------------------------------------- retry rules
def _retry_transform(kind: str, margin: float, bump_static: float, starts,
                     peaks, nseg, t_fail, used, mm, bump=None):
    """Vectorized ``(plan, t_fail, used) -> plan`` over every lane at once.

    Mirrors :mod:`repro_torch.core.retry` rule for rule (``kind``,
    ``margin`` and ``bump_static`` as in ``core.envelope.RetrySpec``); lanes
    that are not retrying are masked out by the caller.  ``mm`` is the
    float32 machine memory (0-d tensor); ``bump`` optionally overrides
    ``bump_static`` per lane (a ``(B,)`` tensor).
    """
    B, K = starts.shape
    idx = torch.arange(K, device=starts.device)[None, :]
    real = idx < nseg[:, None]

    if kind == "none":
        return starts, peaks
    if kind == "double":
        return starts, torch.minimum(peaks * 2.0, mm)
    if kind == "max-machine":
        return starts, mm.expand(B, K).clone()

    # Failed segment: last real slot with start <= t_fail (searchsorted-right
    # semantics; sentinel-padded slots never count).
    j = ((starts <= t_fail[:, None]) & real).sum(dim=1) - 1
    j = torch.minimum(j.clamp(min=0), nseg.long() - 1)
    peak_j = torch.gather(peaks, 1, j[:, None])[:, 0]

    if kind == "kseg-selective":
        target = torch.maximum(peak_j * (1.0 + margin),
                               used * (1.0 + margin))
        return starts, torch.where(idx == j[:, None], target[:, None], peaks)

    if kind == "kseg-partial":
        target = torch.maximum(peak_j * (1.0 + margin),
                               used * (1.0 + margin))
        raise_mask = real & (idx >= j[:, None])
        return starts, torch.where(
            raise_mask, torch.maximum(peaks, target[:, None]), peaks)

    if kind == "ksplus":
        is_last = j >= nseg - 1
        # --- re-time branch: next segment begins exactly at the failure time,
        # every later one is scaled by the same factor.
        nxt = torch.gather(starts, 1, torch.clamp(j + 1, max=K - 1)[:, None])
        nxt = nxt[:, 0]
        tiny = torch.tensor(1e-30, dtype=_F32, device=starts.device)
        factor = torch.where(nxt > 0, t_fail / torch.maximum(nxt, tiny), 0.0)
        st = torch.where(real & (idx > (j + 1)[:, None]),
                         starts * factor[:, None], starts)
        st = torch.where(idx == (j + 1)[:, None], t_fail[:, None], st)
        st = torch.cummax(st.clamp(min=0.0), dim=1).values
        st[:, 0] = 0.0
        st = torch.where(real, st, PAD_START)
        # --- last-segment branch: bump the final peak, keep monotone.
        bump_col = bump_static if bump is None else bump[:, None]
        pk = torch.where(idx == (nseg - 1)[:, None],
                         peaks * (1.0 + bump_col), peaks)
        pk = torch.cummax(pk, dim=1).values
        new_starts = torch.where(is_last[:, None], starts, st)
        new_peaks = torch.where(is_last[:, None], pk, peaks)
        return new_starts, new_peaks

    raise ValueError(f"unknown retry kind: {kind!r}")


# -------------------------------------------------------------------- engine
def _engine_loop(starts, peaks, nseg, mems, lengths, mm, *, kind: str,
                 margin: float, bump: float, dt: float, max_attempts: int,
                 bump_lanes=None):
    """The retry loop over device tensors: ``(wastage, attempts, succ)``.

    A Python loop over attempts (one ``active.any()`` host read each);
    ``bump_lanes`` is an optional ``(B,)`` per-lane override of the ksplus
    ``bump``.
    """
    B, T = mems.shape
    validb = torch.arange(T, device=mems.device)[None, :] < lengths[:, None]
    # Loop-invariant trace precomputes, amortized over every attempt.
    memsneg = torch.where(validb, mems, -torch.inf)
    summem = torch.where(validb, mems, 0.0).sum(dim=1)
    unsat = memsneg.amax(dim=1) > mm  # no allocation can satisfy

    sts, pks = starts, peaks
    active = torch.ones((B,), dtype=torch.bool, device=mems.device)
    succ = torch.zeros((B,), dtype=torch.bool, device=mems.device)
    att = torch.zeros((B,), dtype=torch.int32, device=mems.device)
    w = torch.zeros((B,), dtype=_F32, device=mems.device)
    for _ in range(max_attempts):
        if not bool(active.any()):
            break
        capped = torch.minimum(pks, mm)
        viol, w_succ, w_kill, used = _oom_probe_torch(
            sts, capped, mems, memsneg, lengths, summem, dt)
        failed = viol >= 0
        succ_now = active & ~failed
        w = w + torch.where(succ_now, w_succ, 0.0) \
              + torch.where(active & failed, w_kill, 0.0)
        att = att + active.to(torch.int32)
        succ = succ | succ_now
        retrying = active & failed & ~unsat
        t_fail = viol.clamp(min=0).to(_F32) * dt
        nsts, npks = _retry_transform(
            kind, margin, bump, sts, capped, nseg, t_fail, used, mm,
            bump=bump_lanes)
        sts = torch.where(retrying[:, None], nsts, sts)
        pks = torch.where(retrying[:, None], npks, capped)
        active = retrying
    return w, att, succ


def plain_engine(table, machine_memory: float, dt: float,
                 max_attempts: int) -> torch.Tensor:
    """The PyTorch engine over an :class:`~repro_torch.kernels.wastage.ops.
    GroupTable`, on the table's device: the plain version of the
    ``fleet_engine`` kernel.

    Attempt 1 of every group (the usually-large majority of lanes that
    succeeds at once is settled by span arithmetic), one host read; then
    the failing lanes of each group are compacted and run the full retry
    loop (:func:`_engine_loop`, re-evaluating their first attempt: a small
    price, on a small subset, for a state-free handoff), one more host
    read.  Returns the kernel's ``(3, n_lanes)`` int32 words ``[wastage
    (float32 bits), attempts, succeeded]``, on the CPU.
    """
    dev = table.device
    mm = torch.tensor(machine_memory, dtype=_F32, device=dev)
    dt = float(dt)
    memsneg, viols, wsuccs = {}, [], []
    for g in table.groups:
        mems, lengths = g.mems[:g.B], g.lengths[:g.B]
        key = (g.mems.data_ptr(), g.B)  # groups of one bucket share it
        if key not in memsneg:
            valid = torch.arange(mems.shape[1], device=dev)[None, :] \
                < lengths[:, None]
            memsneg[key] = torch.where(valid, mems, -torch.inf)
        viol, w_succ, _ = _probe_first(
            g.starts, torch.minimum(g.peaks, mm), memsneg[key], lengths,
            g.summem[:g.B], dt)
        viols.append(viol)
        wsuccs.append(w_succ)
    # One host read for every group's first attempt.
    viol = torch.cat(viols).cpu().numpy()
    w = torch.cat(wsuccs).cpu().numpy()
    att = np.ones_like(viol)
    succ = (viol < 0).astype(np.int32)

    fails, outs = [], []
    for g, lo in zip(table.groups, table.lane0[:-1]):
        fail = np.nonzero(viol[lo:lo + g.B] >= 0)[0]
        if fail.size == 0:
            continue
        sel = torch.as_tensor(fail, device=dev)
        starts, peaks, nseg, mems, lengths, bump = (
            None if x is None else x.index_select(0, sel)
            for x in (g.starts, g.peaks, g.nseg, g.mems, g.lengths,
                      g.bump_lanes))
        fails.append(lo + fail)
        outs.append(_engine_loop(
            starts, peaks, nseg, mems, lengths, mm,
            kind=g.kind, margin=g.margin, bump=g.bump, dt=dt,
            max_attempts=max_attempts, bump_lanes=bump))
    if outs:
        # One host read for every retry group's outcome.
        lanes = np.concatenate(fails)
        w[lanes] = torch.cat([o[0] for o in outs]).cpu().numpy()
        att[lanes] = torch.cat([o[1] for o in outs]).cpu().numpy()
        succ[lanes] = torch.cat([o[2] for o in outs]).cpu().numpy()
    return torch.from_numpy(np.stack([w.view(np.int32), att, succ]))
