"""Wrapper of the Mamba2 mix kernels: routing, checks and the launch counts.

:func:`mixer` is the Mamba2 prefill mixer between its two products
(``models/mamba2.py::mamba2_mixer``): from the in-projection's output
``zxbcdt`` through the scan to the out-projection's input.  It takes its
route once, from the device of ``zxbcdt``:

* on the CPU (a CPU mesh's DTensors among them) the plain version,
  :func:`repro_torch.kernels.mamba2_mix.ref.mixer`;
* on CUDA, and inside ``kernels.dryrun.dry_run()`` whatever the device,
  the two hand-written kernels around the scan
  (``csrc/mamba2_mix.cu``): :func:`mix_in` (``in_kernel``: conv, SiLU,
  softplus, the scan's inputs) and :func:`mix_out` (``out_kernel``:
  ``Y + D x``, the gate, the float32 RMSNorm);
* a CUDA mesh's DTensors run the same on each device's batch rows through
  ``local_map`` (the rows whole, the parameters replicated; their
  gradients are partial sums over the batch axes).

The source has two instances, picked by dtype: bfloat16 (serving: 16-byte
vectors, private cp.async rings, one wave) and float32 (float32 models and
their training: a thread an element, a block a row).  When autograd records
(grad enabled and a tensor that requires grad), each kernel runs inside a
``torch.autograd.Function`` whose backward recomputes the kernel's plain
version on the saved inputs and differentiates it: the gradients are the
plain path's at those inputs.

``out_kernel`` rebuilds the conv's x from the in-projection's output (its
three-row halo included) rather than have ``in_kernel`` write it and read
it back, which moves ``B * S * d_inner`` elements fewer
(``csrc/mamba2_mix.cu``).  The kernels refuse what they do not take
(:func:`check`: a conv width other than ``models.blocks.CONV_KW``, another
dtype, strided rows; in bf16 widths off 8 elements and misaligned rows)
rather than route it elsewhere.

The launches are custom operators (``repro_torch::mamba2_mix_in`` and
``mamba2_mix_out``) around the ``ctypes`` calls, whose fake
implementations give a dry run the kernels' outputs (its byte count reads
:func:`io_bytes`).  ``LAUNCHES["mix_in"]`` and ``LAUNCHES["mix_out"]``
count calls that launched a kernel, one each a Mamba2 layer a forward.  The device kernels live in
the namespace ``m2mix``; their names contain neither ``ssd3::`` nor
``ssd_fwd``, the names the benchmark's scan roofline reads.
"""

from __future__ import annotations

import ctypes
import types
from pathlib import Path
from typing import Tuple

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import build, dryrun
from repro_torch.kernels.mamba2_mix import ref

__all__ = ["LAUNCHES", "SOURCE", "reset_launches", "mixer", "check",
           "mix_in", "mix_out", "io_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba2_mix.cu"
VEC = 8                    # bf16 channels of a 16-byte vector
MAX_D_INNER = VEC * 768    # bf16 out_kernel: a row a block, a vector a thread
MAX_D_INNER_F32 = 12288    # m2mix::kMaxDinF32: a float32 row in shared memory
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# in: (zx, w, b, dt_bias, A, X, Adt, Bm, Cm, B, S, Z, din, H, P, GN, stream)
# out: (zx, Y, w, b, D, norm_scale, out, B, S, Z, din, P, eps, stream)
_IN, _OUT = [_P] * 9 + [_I] * 7 + [_P], [_P] * 7 + [_I] * 5 + [_F, _P]
SIGNATURES = {"ksp_mamba2_mix_in_bf16": _IN, "ksp_mamba2_mix_out_bf16": _OUT,
              "ksp_mamba2_mix_in_f32": _IN, "ksp_mamba2_mix_out_f32": _OUT}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

LAUNCHES = {"mix_in": 0, "mix_out": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def mixer(zxbcdt, p, cfg, scan):
    """``(y, final_state)``: the mixer from the in-projection's output
    ``zxbcdt`` (B, S, 2 d_inner + 2 G N + H) to the out-projection's input
    ``y`` (B, S, d_inner), with ``p``'s ``conv_w``, ``conv_b``,
    ``dt_bias``, ``A_log``, ``D`` and ``norm_scale`` and ``cfg``'s widths;
    ``scan(X, Adt, Bm, Cm)`` gives ``(Y, final_state)``."""
    if not _on_card(zxbcdt) and not dryrun.active():
        return ref.mixer(zxbcdt, p, cfg, scan)
    if isinstance(zxbcdt, DTensor):
        return _sharded(zxbcdt, p, cfg, scan)
    X, Adt, Bm, Cm = mix_in(zxbcdt, p.conv_w, p.conv_b, p.dt_bias, p.A_log,
                            cfg.d_inner, cfg.ssm_groups, cfg.ssm_state)
    Y, final = scan(X, Adt, Bm, Cm)
    return mix_out(Y, zxbcdt, p.conv_w, p.conv_b, p.D, p.norm_scale,
                   cfg.norm_eps), final


_PARAMS = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_scale")


def _sharded(zxbcdt, p, cfg, scan):
    """:func:`mixer` of DTensors on each device's batch rows: ``zxbcdt``
    split where its batch is and whole elsewhere, the parameters whole
    (their gradients partial sums over the batch axes)."""
    mesh = zxbcdt.device_mesh
    act = [pl if pl == Shard(0) else Replicate()
           for pl in zxbcdt.placements]
    whole = [Replicate()] * mesh.ndim
    summed = [Partial() if pl == Shard(0) else Replicate() for pl in act]
    params = [getattr(p, name) for name in _PARAMS]

    def local(zx, *ps):
        return mixer(zx, types.SimpleNamespace(**dict(zip(_PARAMS, ps))),
                     cfg, scan)

    return local_map(local, out_placements=(act, act),
                     in_placements=(act,) + (whole,) * len(params),
                     in_grad_placements=(act,) + (summed,) * len(params),
                     device_mesh=mesh, redistribute_inputs=True)(
                         zxbcdt, *params)


def _recording(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check(zxbcdt, conv_w, d_inner, heads, groups, state, Y=None):
    """Validate the kernels' contract; return ``(B, S, Z, P, G * N)``."""
    from repro_torch.models.blocks import CONV_KW
    acts = (("zxbcdt", zxbcdt),) + ((("Y", Y),) if Y is not None else ())
    for name, t in acts + (("conv_w", conv_w),):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    dtype = zxbcdt.dtype
    for name, t in acts:
        if t.dtype not in _SUFFIX:
            raise TypeError(f"the kernels take bfloat16 or float32, {name} "
                            f"is {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, zxbcdt {dtype}")
        if dtype == torch.bfloat16 and _on_card(t) and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (rows read in "
                             f"place)")
    if conv_w.dim() != 2 or conv_w.shape[1] != CONV_KW:
        raise ValueError(f"the kernels take a conv of width {CONV_KW}, got "
                         f"conv_w {tuple(conv_w.shape)}")
    if zxbcdt.dim() != 3:
        raise ValueError(f"zxbcdt must be (B, S, Z), got "
                         f"{tuple(zxbcdt.shape)}")
    B, S, Z = zxbcdt.shape
    din, H, GN = d_inner, heads, groups * state
    if min(B, S, din, H, GN) < 1 or din % H:
        raise ValueError(f"need positive sizes and H | d_inner, got "
                         f"d_inner={din} H={H} G*N={GN}")
    P = din // H
    if Z != 2 * din + 2 * GN + H or conv_w.shape[0] != din + 2 * GN:
        raise ValueError(f"zxbcdt width {Z} and conv_w {tuple(conv_w.shape)}"
                         f" do not fit d_inner={din} G*N={GN} H={H}")
    if dtype == torch.bfloat16:
        for name, n in (("d_inner", din), ("G * N", GN), ("P", P),
                        ("Z", Z)):
            if n % VEC:
                raise ValueError(f"the bf16 kernels read 16-byte vectors of "
                                 f"{VEC} channels: {name} must be a multiple"
                                 f" of {VEC}, got {n}")
    most = MAX_D_INNER if dtype == torch.bfloat16 else MAX_D_INNER_F32
    if din > most:
        raise ValueError(f"out_kernel holds a row in one block: d_inner at "
                         f"most {most} in {dtype}, got {din}")
    if Y is not None and Y.shape != (B, S, H, P):
        raise ValueError(f"Y must be {(B, S, H, P)}, got {tuple(Y.shape)}")
    return B, S, Z, P, GN


def io_bytes(B: int, S: int, d_inner: int, heads: int, groups: int,
             state: int, kernel: str, itemsize: int = 2) -> int:
    """Bytes a kernel must move, each operand read once and each output
    written once (the halo's rows and the parameters' reads by every block
    not counted).  ``mix_in``: xBC and dt_raw in; X, Adt, Bm, Cm out.
    ``mix_out``: Y, z and xBC's x channels in, the normed y out."""
    rows, din, H, GN = B * S, d_inner, heads, groups * state
    if kernel == "mix_in":
        return itemsize * rows * ((din + 2 * GN + H) + (din + H + 2 * GN))
    return itemsize * rows * 4 * din


def mix_in(zxbcdt, conv_w, conv_b, dt_bias, A_log, d_inner, groups, state):
    """The scan's inputs ``(X (B,S,H,P), Adt (B,S,H), Bm, Cm (B,S,G,N))``
    from the in-projection's output ``zxbcdt`` (B, S, 2 d_inner + 2 G N +
    H) on the card: ``in_kernel``, under autograd inside :class:`_MixIn`."""
    ts = (zxbcdt, conv_w, conv_b, dt_bias, A_log)
    dims = (d_inner, groups, state)
    if _recording(*ts):
        return _MixIn.apply(*ts, dims)
    return _launch_in(*ts, *dims)


def mix_out(Y, zxbcdt, conv_w, conv_b, D, norm_scale, eps):
    """The out-projection's input (B, S, d_inner) from the scan's output
    ``Y`` (B,S,H,P) and ``zxbcdt`` on the card: ``rmsnorm((Y + D x) *
    silu(z))``, x rebuilt from ``zxbcdt`` with ``conv_w`` and ``conv_b``;
    ``out_kernel``, under autograd inside :class:`_MixOut`."""
    ts = (Y, zxbcdt, conv_w, conv_b, D, norm_scale)
    if _recording(*ts):
        return _MixOut.apply(*ts, eps)
    return _launch_out(*ts, eps)


def _launch_in(zxbcdt, conv_w, conv_b, dt_bias, A_log, d_inner, groups,
               state):
    check(zxbcdt, conv_w, d_inner, dt_bias.shape[0], groups, state)
    dtype = zxbcdt.dtype
    return torch.ops.repro_torch.mamba2_mix_in(
        zxbcdt, conv_w.to(dtype).contiguous(), conv_b.to(dtype).contiguous(),
        dt_bias.float().contiguous(), (-torch.exp(A_log.float())).contiguous(),
        d_inner, groups, state)


@torch.library.custom_op("repro_torch::mamba2_mix_in", mutates_args=())
def _mix_in_op(zxbcdt: Tensor, w: Tensor, b: Tensor, dt_bias: Tensor,
               A: Tensor, d_inner: int, groups: int, state: int
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One ``in_kernel`` launch: ``(X, Adt, Bm, Cm)``; ``w`` and ``b`` in
    zxbcdt's dtype, ``dt_bias`` and ``A`` (-exp(A_log)) float32."""
    X, Adt, Bm, Cm = _mix_in_fake(zxbcdt, w, b, dt_bias, A, d_inner, groups,
                                  state)
    B, S, Z = zxbcdt.shape
    H = dt_bias.shape[0]
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, f"ksp_mamba2_mix_in_{_SUFFIX[zxbcdt.dtype]}",
                 zxbcdt.device,
                 *(t.data_ptr() for t in (zxbcdt, w, b, dt_bias, A, X, Adt,
                                          Bm, Cm)),
                 B, S, Z, d_inner, H, d_inner // H, groups * state)
    LAUNCHES["mix_in"] += 1
    return X, Adt, Bm, Cm


@_mix_in_op.register_fake
def _mix_in_fake(zxbcdt, w, b, dt_bias, A, d_inner, groups, state):
    B, S, _ = zxbcdt.shape
    H = dt_bias.shape[0]
    return (zxbcdt.new_empty((B, S, H, d_inner // H)),
            zxbcdt.new_empty((B, S, H)),
            zxbcdt.new_empty((B, S, groups, state)),
            zxbcdt.new_empty((B, S, groups, state)))


def _launch_out(Y, zxbcdt, conv_w, conv_b, D, norm_scale, eps):
    d_inner = Y.shape[2] * Y.shape[3]
    check(zxbcdt, conv_w, d_inner, D.shape[0], 1,
          (conv_w.shape[0] - d_inner) // 2, Y=Y)
    dtype = zxbcdt.dtype
    return torch.ops.repro_torch.mamba2_mix_out(
        Y, zxbcdt, conv_w.to(dtype).contiguous(),
        conv_b.to(dtype).contiguous(), D.to(dtype).contiguous(),
        norm_scale.float().contiguous(), float(eps))


@torch.library.custom_op("repro_torch::mamba2_mix_out", mutates_args=())
def _mix_out_op(Y: Tensor, zxbcdt: Tensor, w: Tensor, b: Tensor, D: Tensor,
                scale: Tensor, eps: float) -> Tensor:
    """One ``out_kernel`` launch: the normed, gated ``y`` (B, S, d_inner);
    ``w``, ``b`` and ``D`` in zxbcdt's dtype, ``scale`` float32."""
    out = _mix_out_fake(Y, zxbcdt, w, b, D, scale, eps)
    B, S, Z = zxbcdt.shape
    d_inner = Y.shape[2] * Y.shape[3]
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, f"ksp_mamba2_mix_out_{_SUFFIX[zxbcdt.dtype]}",
                 zxbcdt.device,
                 *(t.data_ptr() for t in (zxbcdt, Y, w, b, D, scale, out)),
                 B, S, Z, d_inner, Y.shape[3], eps)
    LAUNCHES["mix_out"] += 1
    return out


@_mix_out_op.register_fake
def _mix_out_fake(Y, zxbcdt, w, b, D, scale, eps):
    B, S, H, P = Y.shape
    return zxbcdt.new_empty((B, S, H * P))


def _replay(ctx, plain, grads):
    """The gradients, ``grads`` in, of ``plain`` (a kernel's plain version)
    at the saved inputs: recomputed there and differentiated; None for the
    inputs that need none."""
    ins = [t.detach().requires_grad_(need)
           for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads)
             if g is not None and o.requires_grad]
    wanted = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad(
        [o for o, _ in pairs], wanted, [g for _, g in pairs],
        allow_unused=True) if pairs and wanted else ())
    return tuple(next(got, None) if t.requires_grad else None for t in ins)


class _MixIn(torch.autograd.Function):
    """:func:`mix_in` with its gradient: the kernel forward, the backward
    that of ``ref.mix_in`` recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, zxbcdt, conv_w, conv_b, dt_bias, A_log, dims):
        ctx.set_materialize_grads(False)
        ctx.dims = dims
        ctx.save_for_backward(zxbcdt, conv_w, conv_b, dt_bias, A_log)
        return _launch_in(zxbcdt, conv_w, conv_b, dt_bias, A_log, *dims)

    @staticmethod
    def backward(ctx, *grads):
        return (*_replay(ctx, lambda *ins: ref.mix_in(*ins, *ctx.dims)[:4],
                         grads), None)


class _MixOut(torch.autograd.Function):
    """:func:`mix_out` with its gradient: the kernel forward, the backward
    that of ``ref.mix_out`` (x by ``ref.conv_x``) recomputed on the saved
    inputs."""

    @staticmethod
    def forward(ctx, Y, zxbcdt, conv_w, conv_b, D, norm_scale, eps):
        ctx.set_materialize_grads(False)
        ctx.eps = eps
        ctx.save_for_backward(Y, zxbcdt, conv_w, conv_b, D, norm_scale)
        return _launch_out(Y, zxbcdt, conv_w, conv_b, D, norm_scale, eps)

    @staticmethod
    def backward(ctx, dy):
        def plain(Y, zx, w, b, D, scale):
            x = ref.conv_x(zx, w, b, D.shape[0])
            return ref.mix_out(Y, zx, x, D, scale, ctx.eps)
        return (*_replay(ctx, plain, (dy,)), None)
