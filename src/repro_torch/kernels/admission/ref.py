"""Plain PyTorch versions of the admission kernels.

They are the programs the reference jits in ``repro/sched/admission.py``
(``_fused_kernel``, the fits columns; ``_drain_kernel``, the one-dispatch
greedy drain), written as eager float64 tensor operations:

* :func:`plain_columns` — for every requested node ``n`` and queued lane
  ``q``::

      resid[n, q, g] = cap[n] - sum_r alloc_r(now + grid[q, g] - t0[r])
      fits[n, q]     = all_g need[q, g] <= resid[n, q, g] + tol
      minresid[n, q] = min_g resid[n, q, g]

* :func:`plain_drain` — the greedy drain's loop over the carried residuals
  (see its docstring), one host read of the done flag per iteration, and
  the placed lanes' admission-time scatter.

The wrappers in :mod:`repro_torch.kernels.admission.ops` call these for
tensors on the CPU; ``chip_smoke.py`` holds the kernels of
``csrc/admission.cu`` against them on the card.  The kernels sum each
node's residents in order ``r = 0 … R-1`` from 0.0; these sum through
``.sum(dim=1)``, whose order is the device's, so a residual may differ in
its last ulp (the precision contract of
:mod:`repro_torch.sched.admission`).
"""

from __future__ import annotations

import torch

__all__ = ["WINDOW", "plain_columns", "plain_drain"]

WINDOW = 1e-9  # a resident counts inside [t0, t0 + dur + WINDOW)


def _alloc_chain(rs: torch.Tensor, rp: torch.Tensor,
                 relc: torch.Tensor) -> torch.Tensor:
    """Step-function evaluation as a K-step select chain: with ascending
    starts, the last satisfied ``starts_k <= t`` wins — exactly
    ``searchsorted(side='right') - 1`` clipped to ``[0, K-1]``, without a
    ``(lanes, times, K)`` one-hot tensor.  ``(L, K) x (L, M) -> (L, M)``."""
    alloc = rp[:, 0:1].expand(relc.shape)
    for k in range(1, rs.shape[1]):
        alloc = torch.where(rs[:, k:k + 1] <= relc, rp[:, k:k + 1], alloc)
    return alloc


def _residual(starts, peaks, admit_t, dur, caps, run_idx, run_valid, tabs,
              masked: bool) -> torch.Tensor:
    """``resid[n, m] = caps[n] - sum_r alloc_r(tabs[m] - t0[r])`` over each
    node's residents (``run_idx`` ``(N, R)``, padded rows masked out by
    ``run_valid``, nonzero where valid), mirroring ``residual_over``
    elementwise in float64.  ``masked`` selects the anticipating residual
    (a resident only counts inside ``[t0, t0 + dur)``, the cluster's rule)
    over the conservative count-forever one (the elastic planner's)."""
    N, R = run_idx.shape
    flat = run_idx.reshape(-1)
    rel = tabs[None, :] - admit_t[flat][:, None]        # (N*R, M)
    alloc = _alloc_chain(starts[flat], peaks[flat], rel.clamp_min(0.0))
    if masked:
        active = (rel >= 0.0) & (rel < dur[flat][:, None] + WINDOW)
        alloc = torch.where(active, alloc, 0.0)
    alloc = torch.where(run_valid.reshape(-1)[:, None] != 0, alloc, 0.0)
    return caps[:, None] - alloc.reshape(N, R, -1).sum(dim=1)


def plain_columns(starts, peaks, admit_t, dur, need, grid, caps, run_idx,
                  run_valid, q_idx, now, tol, masked: bool) -> torch.Tensor:
    """``(2, N, Q)`` float64: ``fits`` as 1.0 / 0.0, then ``minresid``."""
    N, G = run_idx.shape[0], grid.shape[1]
    tabs = (now + grid[q_idx]).reshape(-1)
    resid = _residual(starts, peaks, admit_t, dur, caps, run_idx, run_valid,
                      tabs, masked).reshape(N, -1, G)
    fits = (need[q_idx][None] <= resid + tol).all(dim=-1)
    return torch.stack([fits.to(torch.float64), resid.amin(dim=-1)])


def plain_drain(starts, peaks, admit_t, dur, need, grid, caps, run_idx,
                run_valid, q_idx, now, tol, masked: bool,
                select: str) -> torch.Tensor:
    """The greedy drain over the queued lanes ``q_idx`` (queue order).

    Base residuals ``resid[n, q, g]`` are computed once from the current
    residents (as :func:`plain_columns`); then each iteration:

    1. recomputes ``fits[n, q]`` from the carried residuals,
    2. places a maximal *order-preserving independent prefix* of the
       queue in one step.  Residual monotonicity proves the picks
       independent: walking lanes in queue order, every fitting lane
       whose fitting-node set is disjoint from the nodes already used
       *this iteration* would be chosen identically by the sequential
       greedy, because none of the entries its decision reads have
       changed.  The prefix stops at the first fitting lane whose fit
       set intersects a used node — it is re-evaluated next iteration,
    3. subtracts each placed lane's windowed envelope from its node's
       residual rows (at most one lane per node per iteration, by the
       cut) and clears the lane's active bit,

    and reads the done flag on the host, until no queued lane fits.
    ``select="first"`` takes the first fitting node, ``"headroom"`` the
    most post-placement head-room ``min_g resid - peak`` (first on ties).
    The placed lanes' admission times are then scattered into ``admit_t``
    (``(B + 1,)``: unused placement slots hold lane ``B``, the spare slot
    past the end, which is never read).

    Returns the ``(2 + 2Q,)`` int64 vector ``[count, iterations,
    lanes[Q], nodes[Q]]``; slots past ``count`` hold ``B``.
    """
    N, Q, G, B = run_idx.shape[0], q_idx.shape[0], grid.shape[1], \
        starts.shape[0]
    dev = q_idx.device
    tabs = (now + grid[q_idx]).reshape(-1)               # (Q*G,) absolute
    resid = _residual(starts, peaks, admit_t, dur, caps, run_idx, run_valid,
                      tabs, masked).reshape(N, Q, G)
    need_q = need[q_idx]
    if select == "headroom":
        peak_q = peaks[q_idx].amax(dim=1)
    # A lane placed inside this drain has admit_t == now *exactly*, so its
    # contribution at grid point (q, g) is evaluated at
    # rel = (now + grid[q, g]) - now — kept in this form (not simplified
    # to grid[q, g]) so the arithmetic matches what the columns compute
    # for that resident afterwards, bitwise.
    prel = tabs - now
    prelc = prel.clamp_min(0.0)[None, :].expand(N, -1)
    nrange = torch.arange(N, dtype=torch.int64, device=dev)
    qrange = torch.arange(Q, dtype=torch.int64, device=dev)
    spare_q = torch.full((), Q, dtype=torch.int64, device=dev)
    spare_n = torch.full((), N, dtype=torch.int64, device=dev)
    active = torch.ones((Q,), dtype=torch.bool, device=dev)
    # slot Q of the placement list and slot N of the node -> lane map
    # are the spares that absorb the unplaced lanes' scatters
    out = torch.full((2, Q + 1), B, dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    iterations = 0
    while True:
        iterations += 1
        fits = (need_q[None] <= resid + tol).all(dim=-1) & active[None]
        anyfit = fits.any(dim=0)                         # (Q,)
        done = ~anyfit.any()
        if select == "first":
            node_q = fits.to(torch.int8).argmax(dim=0)
        else:
            head = resid.amin(dim=-1) - peak_q[None, :]
            node_q = torch.where(fits, head, -torch.inf).argmax(dim=0)
        onehot = (nrange[:, None] == node_q[None, :]) & anyfit[None, :]
        oh = onehot.to(torch.int32)
        before = (oh.cumsum(dim=1) - oh) > 0
        conflict = anyfit & (fits & before).any(dim=0)
        first_conf = torch.where(
            conflict.any(), conflict.to(torch.int8).argmax(), spare_q)
        place = anyfit & (qrange < first_conf) & ~done
        slot = torch.where(place, count + place.cumsum(dim=0) - 1, spare_q)
        out[0].index_put_((slot,), q_idx)
        out[1].index_put_((slot,), node_q)
        count = count + place.sum()
        col = torch.full((N + 1,), Q, dtype=torch.int64, device=dev)
        col.index_put_((torch.where(place, node_q, spare_n),), qrange)
        col = col[:N]
        hasl = col < Q
        gl = q_idx[torch.where(hasl, col, 0)]
        pal = _alloc_chain(starts[gl], peaks[gl], prelc)
        if masked:
            pal = torch.where((prel[None, :] >= 0.0)
                              & (prel[None, :] < dur[gl][:, None] + WINDOW),
                              pal, 0.0)
        pal = torch.where(hasl[:, None], pal, 0.0)
        resid = resid - pal.reshape(N, Q, G)
        active = active & ~place
        # the host read of this iteration: the done flag
        if done.cpu().numpy():
            break
    admit_t.index_fill_(0, out[0, :Q], now)
    return torch.cat([torch.stack([count, torch.full_like(count, iterations)]),
                      out[:, :Q].reshape(-1)])
