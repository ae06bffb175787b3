"""Wrapper of the flash-attention kernel: checks, routing, launch count.

:func:`flash_attention` is the port's counterpart of the reference's
``models/attention.py::chunked_gqa_attention`` on prefill (``q_offset`` 0)
and of its Pallas drop-in ``kernels/flash_attention/ops.py``, in the model
layout.  A tensor on the CPU goes to the plain version
(:mod:`repro_torch.kernels.flash_attention.ref`); a tensor on CUDA goes to
the hand-written kernel (``csrc/flash_attention.cu``) or raises.
``LAUNCHES["flash_attention"]`` counts kernel launches and nothing else.

The launches are custom operators (``torch.ops.repro_torch.flash_attention``
and ``flash_attention_bwd``) around the ``ctypes`` calls, so that a trace
with fake tensors can pass through them: each has a fake implementation
(the outputs the kernel writes, with its shapes and dtypes), a FLOP rule
for ``torch.utils.flop_counter`` (:func:`flops`, the count ``PERF.md``'s
bounds use).  Inside ``kernels.dryrun.dry_run()`` the wrapper calls the
operator whatever the tensors' device.  The operators have no DTensor
sharding rule: given DTensors (a mesh), :func:`flash_attention` runs the
kernel on each device's shard through ``local_map``, the one sharded
route (batch and heads shard; sequence and head dim stay whole); where
the query heads are split over a mesh axis that the KV heads do not
divide, each shard reads the KV heads its query heads use.

The CUDA source has two instances, picked here by dtype:

* bfloat16 (serving): tensor-core products (``wgmma``) on bf16 operands
  with float32 accumulation, tiles brought in by TMA.  q·k is computed from
  q as given and scaled in float32; p is rounded to bf16 for p·v, as the
  reference's serving path does (``models/attention.py:82``).  TMA needs
  ``hd % 8 == 0`` and 16-byte aligned tensors.
* float32 (parity checks): the CUDA-core body; q scaled, softmax and both
  products in float32, as the Pallas kernel.

Both take the head dim as it is (hd <= 128, zamba2's 80 included; the
bf16 forward also hd 152 and 160, Zamba2-2.7B's shared attention), where
the TPU wrapper pads it to 128, and mask ragged sequence tails themselves,
so nothing is padded or copied.  One launch per call.  The softmax scale
defaults to ``1/sqrt(hd)``; a caller may give another (Zamba2's shared
attention: ``(hd / 2) ** -0.5``).

Training: when autograd records (grad enabled and an input that requires
grad), :func:`flash_attention` goes through a ``torch.autograd.Function``
whose forward also has the kernel write the row log-sum-exp ``lse`` (a
nullable output, left null on the serving path) and whose backward is
:func:`flash_attention_bwd`: on CUDA the hand-written backward kernels
(``csrc/flash_attention.cu``), counted by ``LAUNCHES["flash_attention_bwd"]``
once per call; on the CPU ``ref.flash_attention_bwd``.  The bf16 instance
(namespace ``fbwd3``) runs every product on the tensor cores in a dQ kernel
and a dK/dV kernel, without atomics (each gradient is summed by one block in
a fixed order), P and dS rounded to bf16 as operands; the float32 instance
(namespace ``fbwd``) is the CUDA-core body kept for the float32 parity
checks.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, dryrun
from repro_torch.kernels.flash_attention import ref

__all__ = ["LAUNCHES", "SOURCE", "reset_launches", "flash_attention",
           "flash_attention_bwd", "attended_pairs", "flops", "io_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HD = 128  # kMaxHd in csrc/flash_attention.cu
# the bf16 forward's instances (fa3::launch): hd rounded up to 16
BF16_FWD_HDS = (16, 32, 48, 64, 80, 96, 112, 128, 160)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, out, lse or null, B, Sq, Skv, H, K, hd, causal, window or 0,
#  scale, stream)
_ARGS = [_P] * 5 + [_I] * 8 + [_F, _P]
# (q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, K, hd, causal,
#  window or 0, scale, stream)
_BWD_ARGS = [_P] * 10 + [_I] * 8 + [_F, _P]
SIGNATURES = {"ksp_flash_attention_f32": _ARGS,
              "ksp_flash_attention_bf16": _ARGS,
              "ksp_flash_attention_bwd_f32": _BWD_ARGS,
              "ksp_flash_attention_bwd_bf16": _BWD_ARGS}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q, k, v, window, backward=False):
    """Validate the kernel contract; return ``(B, Sq, Skv, H, K, hd)``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype not in _SUFFIX:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, K, hd) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if min(B, Sq, Skv, H, K, hd) < 1 or H % K:
        raise ValueError(f"need positive sizes and K | H, got H={H} K={K}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cuda" and hd > MAX_HD and (
            backward or q.dtype != torch.bfloat16
            or -(-hd // 16) * 16 not in BF16_FWD_HDS):
        raise ValueError(f"the kernel takes hd <= {MAX_HD} (the bf16 "
                         f"forward also 152 and 160), got {hd}")
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        build.check_tma(hd, q=q, k=k, v=v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return B, Sq, Skv, H, K, hd


def attended_pairs(Sq: int, Skv: int, causal: bool,
                   window: Optional[int]) -> int:
    """(query, key) pairs inside the mask: key j of query i when ``j <= i``
    (causal) and ``j > i - window`` (windowed)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flops(B: int, Sq: int, Skv: int, H: int, hd: int, causal: bool,
          window: Optional[int], backward: bool = False) -> int:
    """The kernel's FLOPs: q.k and p.v (2 * hd each) over the attended
    pairs (it skips the tiles outside the mask); the backward's five
    products are 2.5 times the forward's two."""
    n = 4 * hd * B * H * attended_pairs(Sq, Skv, causal, window)
    return int(2.5 * n) if backward else n


def io_bytes(B: int, Sq: int, Skv: int, H: int, K: int, hd: int,
             itemsize: int, with_lse: bool = False,
             backward: bool = False) -> int:
    """Bytes the kernel must move: each input read once and each output
    written once (forward: q, k, v, out and the float32 row lse when
    training; backward: q, k, v, o, dO, dq, dk, dv and lse)."""
    rows_q, rows_kv = B * Sq * H * hd, B * Skv * K * hd
    if backward:
        return (4 * rows_q + 4 * rows_kv) * itemsize + 4 * B * H * Sq
    return (2 * rows_q + 2 * rows_kv) * itemsize \
        + (4 * B * H * Sq if with_lse else 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention forward in the model layout.

    q: (B,Sq,H,hd); k/v: (B,Skv,K,hd), query head h reads KV head h // G;
    causal mask aligned top-left (k <= q); optional window (k > q - window);
    scores scaled by ``scale`` (default ``1/sqrt(hd)``).
    All of one dtype (float32 or bfloat16), contiguous, on one device (or
    DTensors on one mesh).  Returns (B,Sq,H,hd) in q's dtype.
    """
    if isinstance(q, DTensor):
        return _sharded(q, k, v, causal, window, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, with_lse=False, scale=scale)[0]


def _forward(q, k, v, causal, window, with_lse, scale=None):
    """``(out, lse or None)``: the kernel's operator on CUDA (or in a dry
    run), the plain version on the CPU (which always computes ``lse``)."""
    _check(q, k, v, window)
    if q.device.type == "cpu" and not dryrun.active():
        if with_lse:
            return ref.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, scale=scale)
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale), None
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal,
                                                     window, with_lse, scale)
    return out, (lse if with_lse else None)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              window: Optional[int], with_lse: bool,
              scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """One launch: ``(out, lse)``, ``lse`` (B, H, Sq) float32 when
    ``with_lse``, else (B, H, 0) and left null for the kernel."""
    B, Sq, H, hd = q.shape
    scale = ref.default_scale(hd) if scale is None else scale
    Skv, K = k.shape[1], k.shape[2]
    out, lse = _flash_fake(q, k, v, causal, window, with_lse, scale)
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, f"ksp_flash_attention_{_SUFFIX[q.dtype]}", q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 B, Sq, Skv, H, K, hd, int(causal), window or 0, scale)
    LAUNCHES["flash_attention"] += 1
    return out, lse


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, with_lse, scale=None):
    B, Sq, H, _ = q.shape
    lse = torch.empty((B, H, Sq if with_lse else 0), dtype=torch.float32,
                      device=q.device)
    return torch.empty_like(q), lse


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, with_lse, *args,
                 out_shape=None, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return flops(B, Sq, k_shape[1], H, hd, causal, window)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` from the
    saved ``q, k, v``, its output ``o``, the output's gradient ``do`` (same
    shape, dtype and device as q, contiguous) and the forward's ``lse``
    (B, H, Sq) float32: the backward kernel on CUDA, the plain version on
    the CPU."""
    B, Sq, Skv, H, K, hd = _check(q, k, v, window, backward=True)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor like q")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous (B, H, Sq) float32 "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if q.device.type == "cpu" and not dryrun.active():
        return ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       window=window, scale=scale)
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        build.check_tma(hd, do=do)
    return torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, do, lse,
                                                     causal, window, scale)


def bwd_scratch_bytes(B: int, Sq: int, H: int) -> int:
    """The backward's row scratch: D (B, H, Sq) for the float32 kernels;
    lse log2(e) and D, each padded to whole 128-row tiles, for the bf16
    ones (allocated for both)."""
    return 4 * B * H * 2 * -(-Sq // 128) * 128


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
                  lse: Tensor, causal: bool, window: Optional[int],
                  scale: Optional[float] = None
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """One launch: ``(dq, dk, dv)``."""
    B, Sq, H, hd = q.shape
    scale = ref.default_scale(hd) if scale is None else scale
    Skv, K = k.shape[1], k.shape[2]
    dq, dk, dv = _flash_bwd_fake(q, k, v, o, do, lse, causal, window, scale)
    D = torch.empty(bwd_scratch_bytes(B, Sq, H) // 4, dtype=torch.float32,
                    device=q.device)
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, f"ksp_flash_attention_bwd_{_SUFFIX[q.dtype]}",
                 q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), D.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, Sq, Skv, H, K, hd, int(causal), window or 0, scale)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, o, do, lse, causal, window, scale=None):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, do_shape, lse_shape,
                     causal, window, *args, out_shape=None, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return flops(B, Sq, k_shape[1], H, hd, causal, window, backward=True)


def _sharded(q, k, v, causal, window, scale):
    """:func:`flash_attention` of DTensors: each device runs the kernel on
    its shard through ``local_map``.  The batch shards with q; heads shard
    on the mesh axes where q's do.  Where k/v's heads are whole on such an
    axis (the KV heads do not divide it), each shard slices out the KV
    heads its query heads read (GQA: query head h reads KV head h // G)."""
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    G = H // K
    q_pl, kv_pl, split = [], [], []
    for d, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pq == Shard(0):
            q_pl.append(pq)
            kv_pl.append(pq)
        elif pq == Shard(2):
            q_pl.append(pq)
            kv_pl.append(pk if pk == Shard(2) else Replicate())
            if pk != Shard(2):
                split.append(d)
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    if len(split) > 1 or (split and any(p == Shard(2) for p in kv_pl)):
        raise NotImplementedError(
            f"query heads split over mesh axes {split} with KV heads "
            f"placed {k.placements}")

    def local(ql, kl, vl):
        if split:
            d = split[0]
            h0 = mesh.get_local_rank(d) * ql.shape[2]
            n = max(ql.shape[2] // G, 1)
            kl = kl[:, :, h0 // G:h0 // G + n].contiguous()
            vl = vl[:, :, h0 // G:h0 // G + n].contiguous()
        return flash_attention(ql, kl, vl, causal=causal, window=window,
                               scale=scale)

    # where a shard reads a slice of whole k/v, their gradients are
    # partial sums over that axis
    kv_grad = [Partial() if d in split else p for d, p in enumerate(kv_pl)]
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its gradient: the forward kernel saves
    ``lse``, the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, with_lse=True,
                            scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=ctx.causal,
                                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None
