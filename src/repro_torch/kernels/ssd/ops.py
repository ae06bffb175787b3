"""Wrapper of the SSD kernel: checks, routing and the launch count.

:func:`ssd` is the port's counterpart of the reference's
``models/mamba2.py::ssd_chunked`` and of its Pallas drop-in
``kernels/ssd/ops.py::ssd_pallas``, in the model layout.  A tensor on the
CPU goes to the plain version (:mod:`repro_torch.kernels.ssd.ref`); a
tensor on CUDA goes to the hand-written kernel (``csrc/ssd.cu``) or raises.
``LAUNCHES["ssd"]`` counts calls that launched the kernel: one per
:func:`ssd` call, whatever the number of device kernels the call issues.

The launches are custom operators (``torch.ops.repro_torch.ssd`` and
``ssd_bwd``) around the ``ctypes`` calls, so that a trace with fake tensors
can pass through them: each has a fake implementation (the outputs and the
saved states the kernel writes, with its shapes and dtypes), a FLOP rule
for ``torch.utils.flop_counter`` (:func:`flops`, the count ``PERF.md``'s
bounds use).  Inside ``kernels.dryrun.dry_run()`` the wrapper calls the
operator whatever the tensors' device.  The operators have no DTensor
sharding rule: given DTensors (a mesh), :func:`ssd` runs the kernel on
each device's shard through ``local_map``, the one sharded route: the
batch shards, and the heads where every group is whole on a device;
sequence, head dim and state stay whole.

The CUDA source has two instances, picked here by dtype:

* bfloat16 (serving): three device kernels per call (chunk states, state
  passing, chunk scan) with tensor-core products (``wgmma``) on bf16
  operands, float32 accumulation and tiles brought in by TMA.  They chunk by
  ``CHUNK_BF16`` = 256 rows whatever the model's ``chunk``, and take their
  scratch from this wrapper: the chunk states (float32), the states
  entering each chunk (a bf16 hi and lo pair) and the chunk cumsums
  (float32).  TMA needs ``P`` and ``N`` multiples of 8 and 16-byte aligned
  tensors.
* float32 (parity checks): one device kernel, one block per (b, h) carrying
  the state every ``SUB_CHUNK`` = 64 rows on the CUDA cores.

The scan's result does not depend on the chunk size
(``tests/test_models.py::test_mamba_chunk_invariance``); the plain version
chunks by ``chunk``.  The kernels read ragged tails as zeros, so nothing is
padded.  The scan starts from a zero state: the reference's
``initial_state`` argument has no caller in either package and is not
carried over.

Training: when autograd records (grad enabled and an input that requires
grad), :func:`ssd` goes through a ``torch.autograd.Function`` whose
backward is :func:`ssd_bwd`: on CUDA the hand-written backward kernels
(``csrc/ssd.cu``), counted by ``LAUNCHES["ssd_bwd"]`` once per call; on the
CPU ``ref.ssd_bwd``.  Two instances, picked by dtype:

* bfloat16 (training, namespace ``sbwd3``): the forward's chunks of
  ``CHUNK_BWD_BF16`` = 256 rows, tensor-core products (``wgmma``) on bf16
  hi / lo operand pairs, tiles brought in by TMA.  It reads the states
  entering each chunk and the chunk cumsums that the bf16 forward computed
  (the ``_SSD`` function saves them, ~11 MB a call at zamba2's 1 x 2048);
  called without them (``states=None``), the wrapper has the kernel run the
  forward's first two passes to get them.
* float32 (parity checks, namespace ``sbwd``): four device kernels on the
  CUDA cores, chunks of ``CHUNK_BWD`` = 32 rows, recomputing the entering
  states from the inputs.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, dryrun
from repro_torch.kernels.ssd import ref

__all__ = ["LAUNCHES", "SOURCE", "SUB_CHUNK", "CHUNK_BF16", "CHUNK_BWD",
           "CHUNK_BWD_BF16", "reset_launches", "ssd", "ssd_bwd", "flops",
           "io_bytes", "scratch_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
SUB_CHUNK = 64        # kSub in csrc/ssd.cu (float32 instance)
CHUNK_BF16 = 256      # ssd3::kT in csrc/ssd.cu (bf16 instance)
CHUNK_BWD = 32        # sbwd::kBt in csrc/ssd.cu (float32 backward)
CHUNK_BWD_BF16 = 256  # the forward's ssd3::kT (bf16 backward, sbwd3)
MAX_P = MAX_N = 128   # kMaxP / kMaxN in csrc/ssd.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
# f32: (x, a, b, c, y, final, B, S, H, P, G, N, stream)
# bf16: (x, a, b, c, y, final, states, s_in, cum, B, S, H, P, G, N, stream)
# bwd f32: (x, a, b, c, dy, dfinal, dx, da, db, dc, states, dstates, clast,
#           dbh, dch, B, S, H, P, G, N, stream)
# bwd bf16: (x, a, b, c, dy, dfinal, dx, da, db, dc, s_in, cum, have_states,
#            own, final, ds, wpart, rows, dbh, dch, B, S, H, P, G, N, stream)
SIGNATURES = {"ksp_ssd_f32": [_P] * 6 + [_I] * 6 + [_P],
              "ksp_ssd_bf16": [_P] * 9 + [_I] * 6 + [_P],
              "ksp_ssd_bwd_f32": [_P] * 15 + [_I] * 6 + [_P],
              "ksp_ssd_bwd_bf16": [_P] * 12 + [_I] + [_P] * 7 + [_I] * 6
              + [_P]}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

LAUNCHES = {"ssd": 0, "ssd_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(X, A, Bm, Cm, chunk):
    """Validate the kernel contract; return ``(B, S, H, P, G, N)``."""
    for name, t in (("X", X), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype not in _SUFFIX:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != X.dtype:
            raise TypeError(f"{name} is {t.dtype}, X is {X.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if X.dim() != 4 or A.dim() != 3 or Bm.dim() != 4:
        raise ValueError("X must be (B,S,H,P), A (B,S,H), Bm/Cm (B,S,G,N)")
    B, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if A.shape != (B, S, H) or Bm.shape != (B, S, G, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"shapes X {tuple(X.shape)} A {tuple(A.shape)} "
                         f"Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)}")
    if min(B, S, H, P, G, N) < 1 or H % G:
        raise ValueError(f"need positive sizes and G | H, got H={H} G={G}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if X.device.type == "cuda" and (P > MAX_P or N > MAX_N):
        raise ValueError(f"the kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P={P} N={N}")
    if X.device.type == "cuda" and X.dtype == torch.bfloat16:
        build.check_tma(P, N, X=X, Bm=Bm, Cm=Cm)
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")
    return B, S, H, P, G, N


def flops(B: int, S: int, H: int, P: int, N: int,
          backward: bool = False) -> int:
    """The scan's FLOPs in its fixed 64-row form (the bound may not move
    with the kernel's tiling): per sub-chunk of each head, C.B and G.x over
    the lower triangle, C.state and the state update in full; the backward
    has two gradient products for each forward product."""
    T = 64
    n = B * H * -(-S // T) * (T * (T + 1) * (N + P) + 4 * T * P * N)
    return 2 * n if backward else n


def io_bytes(B: int, S: int, H: int, P: int, G: int, N: int, itemsize: int,
             backward: bool = False) -> int:
    """Bytes the kernel must move, each input read once and each output
    written once: x, a, B, C in, y (and the float32 final state) out; the
    backward reads x, a, B, C, dY and writes dx, da, dB, dC.  Scratch
    counts against the kernel's time, not here."""
    if backward:
        return (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * G * N) \
            * itemsize
    return (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) * itemsize \
        + B * H * P * N * 4


def scratch_bytes(B: int, S: int, H: int, P: int, N: int, dtype,
                  backward: bool = False, have_states: bool = True) -> int:
    """Device scratch a call allocates and frees inside its launch (the
    saved entering states and cumsums are outputs, not scratch)."""
    if dtype == torch.bfloat16:
        nc = -(-S // CHUNK_BF16)
        if not backward:
            return 4 * B * nc * H * P * N                    # chunk states
        own = 4 * B * nc * H * P * N
        ds = 2 * B * nc * H * 2 * P * N
        wpart = 4 * B * H * nc * -(-(P * N) // 256)
        rows = 4 * 3 * B * H * nc * CHUNK_BWD_BF16
        dbh = 2 * 4 * B * S * H * N
        made = 0 if have_states else (2 * B * nc * H * 2 * P * N
                                      + 4 * B * H * nc * CHUNK_BWD_BF16
                                      + 4 * B * H * P * N)
        return own + ds + wpart + rows + dbh + made
    if not backward:
        return 0
    nc = -(-S // CHUNK_BWD)
    return 4 * (2 * B * nc * H * P * N + B * H * nc + 2 * B * S * H * N)


def ssd(X: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int):
    """Chunked SSD scan in the model layout.

    X: (B,S,H,P) inputs pre-multiplied by dt; A: (B,S,H) log-decay
    increments; Bm/Cm: (B,S,G,N), head h reads group h // (H/G); all of one
    dtype (float32 or bfloat16), contiguous, on one device.
    Returns ``(Y (B,S,H,P) in X's dtype, final_state (B,H,P,N) float32)``.
    """
    if isinstance(X, DTensor):
        return _sharded(X, A, Bm, Cm, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (X, A, Bm, Cm)):
        return _SSD.apply(X, A, Bm, Cm, chunk)
    return _forward(X, A, Bm, Cm, chunk)[:2]


def _sharded(X, A, Bm, Cm, chunk):
    """:func:`ssd` of DTensors on each device's shard: the batch where X's
    batch is split, the heads (with their groups) where X's heads are split
    and the mesh axis divides the groups; everything else whole."""
    mesh = X.device_mesh
    G = Bm.shape[2]
    pl, final_pl = [], []
    for p, m in zip(X.placements, mesh.shape):
        if p == Shard(0):
            pl.append(p)
            final_pl.append(p)
        elif p == Shard(2) and G % m == 0:
            pl.append(p)
            final_pl.append(Shard(1))
        else:
            pl.append(Replicate())
            final_pl.append(Replicate())
    return local_map(lambda *a: ssd(*a, chunk),
                     out_placements=(pl, final_pl),
                     in_placements=(pl, pl, pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(X, A, Bm, Cm)


def _forward(X, A, Bm, Cm, chunk):
    """``(y, final, states)``: ``states`` is the bf16 kernel's ``(s_in,
    cum)`` (what :func:`ssd_bwd` can reuse), None otherwise."""
    _check(X, A, Bm, Cm, chunk)
    if X.device.type == "cpu" and not dryrun.active():
        return (*ref.ssd(X, A, Bm, Cm, chunk), None)
    y, final, s_in, cum = torch.ops.repro_torch.ssd(X, A, Bm, Cm)
    return y, final, (s_in, cum) if X.dtype == torch.bfloat16 else None


@torch.library.custom_op("repro_torch::ssd", mutates_args=(),
                         device_types="cuda")
def _ssd_op(X: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor
            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One launch: ``(y, final, s_in, cum)``; the bf16 kernel's entering
    states and cumsums, empty (no chunks) for the float32 kernel."""
    B, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y, final, s_in, cum = _ssd_fake(X, A, Bm, Cm)
    lib = build.load(SOURCE, SIGNATURES)
    ptrs = [X.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), final.data_ptr()]
    if X.dtype == torch.bfloat16:
        states = torch.empty((B, s_in.shape[1], H, P, N),
                             dtype=torch.float32, device=X.device)
        ptrs += [states.data_ptr(), s_in.data_ptr(), cum.data_ptr()]
    build.launch(lib, f"ksp_ssd_{_SUFFIX[X.dtype]}", X.device, *ptrs,
                 B, S, H, P, G, N)
    LAUNCHES["ssd"] += 1
    return y, final, s_in, cum


@_ssd_op.register_fake
def _ssd_fake(X, A, Bm, Cm):
    B, S, H, P = X.shape
    N = Bm.shape[3]
    nc = -(-S // CHUNK_BF16) if X.dtype == torch.bfloat16 else 0
    f32 = dict(dtype=torch.float32, device=X.device)
    return (torch.empty_like(X), torch.empty((B, H, P, N), **f32),
            torch.empty((B, nc, H, 2, P, N), dtype=torch.bfloat16,
                        device=X.device),
            torch.empty((B, H, nc, CHUNK_BF16), **f32))


@register_flop_formula(torch.ops.repro_torch.ssd)
def _ssd_flops(x_shape, a_shape, b_shape, c_shape, *args, out_shape=None,
               **kwargs) -> int:
    B, S, H, P = x_shape
    return flops(B, S, H, P, b_shape[3])


def ssd_bwd(X: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int, dY: torch.Tensor,
            dfinal: torch.Tensor = None, states=None):
    """The gradients ``(dX, dA, dBm, dCm)`` of :func:`ssd` from its inputs,
    ``dY`` (like X, contiguous) and the final state's gradient ``dfinal``
    (B, H, P, N) float32, or None when the final state is unused: the
    backward kernels on CUDA, the plain version on the CPU.  ``states`` is
    what the bf16 forward kernel computed for the same inputs, ``(s_in
    (B, nc, H, 2, P, N) bf16, cum (B, H, nc, 256) float32)`` with
    nc = ceil(S / 256), or None: the bf16 kernel then computes them itself
    (the float32 kernel and the plain version never read them)."""
    B, S, H, P, G, N = _check(X, A, Bm, Cm, chunk)
    if dY.shape != X.shape or dY.dtype != X.dtype \
            or dY.device != X.device or not dY.is_contiguous():
        raise ValueError("dY must be a contiguous tensor like X")
    if dfinal is not None and (
            dfinal.shape != (B, H, P, N) or dfinal.dtype != torch.float32
            or dfinal.device != X.device or not dfinal.is_contiguous()):
        raise ValueError(f"dfinal must be a contiguous (B, H, P, N) float32 "
                         f"tensor on {X.device}")
    if X.device.type == "cpu" and not dryrun.active():
        return ref.ssd_bwd(X, A, Bm, Cm, chunk, dY, dfinal)
    s_in, cum = states if states is not None else (None, None)
    if X.device.type == "cuda" and X.dtype == torch.bfloat16:
        build.check_tma(P, dY=dY)
    return torch.ops.repro_torch.ssd_bwd(X, A, Bm, Cm, dY, dfinal, s_in, cum)


@torch.library.custom_op("repro_torch::ssd_bwd", mutates_args=(),
                         device_types="cuda")
def _ssd_bwd_op(X: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, dY: Tensor,
                dfinal: Optional[Tensor], s_in: Optional[Tensor],
                cum: Optional[Tensor]
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One launch: ``(dX, dA, dBm, dCm)``."""
    B, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dX, dA, dBm, dCm = _ssd_bwd_fake(X, A, Bm, Cm, dY, dfinal, s_in, cum)
    if X.dtype == torch.bfloat16:
        states = None if s_in is None else (s_in, cum)
        _bwd_bf16(X, A, Bm, Cm, dY, dfinal, states, dX, dA, dBm, dCm)
        LAUNCHES["ssd_bwd"] += 1
        return dX, dA, dBm, dCm
    f32 = dict(dtype=torch.float32, device=X.device)
    nc = -(-S // CHUNK_BWD)
    chunk_states = torch.empty((B, nc, H, P, N), **f32)
    dstates = torch.empty_like(chunk_states)
    clast = torch.empty((B, H, nc), **f32)
    dbh = torch.empty((B, S, H, N), **f32)
    dch = torch.empty_like(dbh)
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, f"ksp_ssd_bwd_{_SUFFIX[X.dtype]}", X.device,
                 *(t.data_ptr() for t in (X, A, Bm, Cm, dY)),
                 None if dfinal is None else dfinal.data_ptr(),
                 *(t.data_ptr() for t in (dX, dA, dBm, dCm, chunk_states,
                                          dstates, clast, dbh, dch)),
                 B, S, H, P, G, N)
    LAUNCHES["ssd_bwd"] += 1
    return dX, dA, dBm, dCm


@_ssd_bwd_op.register_fake
def _ssd_bwd_fake(X, A, Bm, Cm, dY, dfinal, s_in, cum):
    return tuple(torch.empty_like(t) for t in (X, A, Bm, Cm))


@register_flop_formula(torch.ops.repro_torch.ssd_bwd)
def _ssd_bwd_flops(x_shape, a_shape, b_shape, *args, out_shape=None,
                   **kwargs) -> int:
    B, S, H, P = x_shape
    return flops(B, S, H, P, b_shape[3], backward=True)


def _bwd_bf16(X, A, Bm, Cm, dY, dfinal, states, dX, dA, dBm, dCm):
    """One launch of the bf16 backward (``sbwd3``) with its scratch."""
    B, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // CHUNK_BWD_BF16)
    dev = X.device
    f32 = dict(dtype=torch.float32, device=dev)
    state_shape = (B, nc, H, 2, P, N)
    cum_shape = (B, H, nc, CHUNK_BWD_BF16)
    if states is None:
        s_in = torch.empty(state_shape, dtype=torch.bfloat16, device=dev)
        cum = torch.empty(cum_shape, **f32)
        final = torch.empty((B, H, P, N), **f32)
    else:
        s_in, cum = states
        for name, t, shape, dtype in (("s_in", s_in, state_shape,
                                       torch.bfloat16),
                                      ("cum", cum, cum_shape, torch.float32)):
            if t.shape != shape or t.dtype != dtype or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"states: {name} must be a contiguous "
                                 f"{shape} {dtype} tensor on {dev}")
        final = None
    own = torch.empty((B, nc, H, P, N), **f32)
    ds = torch.empty(state_shape, dtype=torch.bfloat16, device=dev)
    wpart = torch.empty((B, H, nc, -(-(P * N) // 256)), **f32)
    rows = torch.empty((3, B, H, nc * CHUNK_BWD_BF16), **f32)
    dbh = torch.empty((B, S, H, N), **f32)
    dch = torch.empty_like(dbh)
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, "ksp_ssd_bwd_bf16", dev,
                 *(t.data_ptr() for t in (X, A, Bm, Cm, dY)),
                 None if dfinal is None else dfinal.data_ptr(),
                 *(t.data_ptr() for t in (dX, dA, dBm, dCm, s_in, cum)),
                 int(states is not None), own.data_ptr(),
                 None if final is None else final.data_ptr(),
                 *(t.data_ptr() for t in (ds, wpart, rows, dbh, dch)),
                 B, S, H, P, G, N)


class _SSD(torch.autograd.Function):
    """:func:`ssd` with its gradient: the backward is :func:`ssd_bwd` on the
    saved inputs and, from the bf16 kernel, its entering states and
    cumsums (the final state's gradient is None when it is unused)."""

    @staticmethod
    def forward(ctx, X, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        y, final, states = _forward(X, A, Bm, Cm, chunk)
        ctx.save_for_backward(X, A, Bm, Cm, *(states or ()))
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dY, dfinal):
        X, A, Bm, Cm, *states = ctx.saved_tensors
        dY = torch.zeros_like(X) if dY is None else dY.contiguous()
        if dfinal is not None:
            dfinal = dfinal.float().contiguous()
        return (*ssd_bwd(X, A, Bm, Cm, ctx.chunk, dY, dfinal,
                         tuple(states) or None), None)
