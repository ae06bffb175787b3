"""Wrapper of the decode-attention kernel: checks, routing, launch count.

:func:`decode_attention` is one query token against a (possibly ring) KV
cache, the port's counterpart of the reference's
``models/attention.py::decode_gqa_attention`` (a plain einsum there, no
Pallas kernel).  A tensor on the CPU goes to the plain version
(:mod:`repro_torch.kernels.decode_attention.ref`); a tensor on CUDA goes to
the hand-written kernel (``csrc/decode_attention.cu``) or raises.  The
kernel reads the cache once, in place, in its (B, cap, K, hd) layout, where
the plain version's einsums copy it (K cast to float32 and transposed, V
transposed) in every layer.  Given this token's K and V rows (``k_new``,
``v_new``), it first writes them into their slot, ``pos % cap``, as
``models.attention.append_kv`` does, so a layer's decode attention is one
call.  Both routes check the kernel's contract, so a CPU run refuses what
the card would.

The launch is a custom operator (``torch.ops.repro_torch.decode_attention``)
around the ``ctypes`` call, so that a trace with fake tensors passes through
it: a fake implementation (the output), a FLOP rule (:func:`flops`, what the
plain version's two einsums count) and, for the dry run's bytes,
:func:`io_bytes` and :func:`scratch_bytes`.  Inside
``kernels.dryrun.dry_run()`` the wrapper calls the operator whatever the
tensors' device.  DTensor caches do not reach this module:
``models.attention`` runs it on each device's shard through ``local_map``.

Each call is one ``ctypes`` call whose entry point launches the kernel's
two passes (scores, then p.v) and, when the slots are split, the combine
of the splits; ``LAUNCHES["decode_attention"]`` counts calls, one a layer
of a decode step.
The split (:func:`plan`) follows the shapes and the card's SM count.  Both
instances, bfloat16 (serving) and float32 (parity checks), compute the plain
version's arithmetic; only the order of the sums differs.  A lane holds at
most two 16-byte chunks of a head row (``MAX_ROW_BYTES``): bfloat16 takes
hd up to 256, float32 up to 128.  So a float32 decode with hd 160
(stablelm-12b) raises, on the CPU as on the card, where the plain einsums
ran before; every model's bfloat16 decode takes the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, dryrun
from repro_torch.kernels.decode_attention import ref
from repro_torch.obs import trace as _obs

__all__ = ["LAUNCHES", "SOURCE", "COUNT", "reset_launches",
           "decode_attention", "plan", "flops", "io_bytes", "scratch_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_ROW_BYTES = 512   # a lane takes at most two 16-byte chunks of a row
H100_SMS = 132        # the dry run's card
TILE = 32             # slots a tile of the kernel's ring (kHalfWarps * 4)
MIN_SPLIT = 256       # no split shorter than this many slots
MAX_SPLIT = 1024
BLOCKS_PER_SM = 8     # resident blocks of the G = 1 kernels (24 KB rings)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, k_new or null, v_new or null, kv_positions, pos, out, scratch,
#  B, cap, H, K, hd, window or 0, split_len, scale, stream)
_ARGS = [_P] * 9 + [_I] * 7 + [_F, _P]
SIGNATURES = {"ksp_decode_attention_f32": _ARGS,
              "ksp_decode_attention_bf16": _ARGS}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the tracer's count of kernel calls, on the innermost span (``attention``)
COUNT = "attention.decode_kernel"

LAUNCHES = {"decode_attention": 0}
_sms: dict = {}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def _check(q, cache_k, cache_v, kv_positions, pos, window, k_new, v_new):
    """Validate the kernel contract; return ``(B, cap, H, K, hd)``."""
    if (k_new is None) != (v_new is None):
        raise ValueError("give both k_new and v_new, or neither")
    new = () if k_new is None else (("k_new", k_new), ("v_new", v_new))
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
                    ("kv_positions", kv_positions), ("pos", pos)) + new:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)) + new:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("kv_positions", kv_positions), ("pos", pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if cache_k.dim() != 4:
        raise ValueError("caches must be (B, cap, K, hd)")
    cap, K = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape != (B, cap, K, hd) or cache_v.shape != cache_k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} cache_k "
                         f"{tuple(cache_k.shape)} cache_v "
                         f"{tuple(cache_v.shape)}")
    if any(t.shape != (B, 1, K, hd) for _, t in new):
        raise ValueError(f"k_new and v_new must be ({B}, 1, {K}, {hd})")
    if kv_positions.shape != (B, cap) or pos.shape != (B,):
        raise ValueError(f"kv_positions must be ({B}, {cap}) and pos "
                         f"({B},), got {tuple(kv_positions.shape)} and "
                         f"{tuple(pos.shape)}")
    if min(B, cap, H, K, hd) < 1 or H % K:
        raise ValueError(f"need positive sizes and K | H, got H={H} K={K}")
    if hd % 8 or hd * q.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"the kernel takes hd a multiple of 8 with rows of "
                         f"at most {MAX_ROW_BYTES} bytes, got hd={hd} in "
                         f"{q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cuda":
        for name, t in (("q", q), ("cache_k", cache_k),
                        ("cache_v", cache_v)) + new:
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return B, cap, H, K, hd


def _group(G: int) -> int:
    """Query heads a block takes at once (the kernel's GT): the smallest
    power of two that holds G, at most 8."""
    return min(8, 1 << (G - 1).bit_length())


def plan(B: int, K: int, G: int, cap: int, sms: int) -> int:
    """Slots a split (``split_len``): as many splits as one wave of the
    card's ``sms`` SMs at ``BLOCKS_PER_SM`` holds (a second, partial wave
    would leave SMs idle), no split shorter than ``MIN_SPLIT`` slots
    (unless the cache is), none longer than ``min(MAX_SPLIT, 2048 / GT)``
    (its p fits the block's shared memory), a whole number of tiles."""
    gt = _group(G)
    blocks = B * K * -(-G // gt)
    longest = min(MAX_SPLIT, 2048 // gt)
    n = max(-(-cap // longest), min(BLOCKS_PER_SM * sms // blocks,
                                    -(-cap // MIN_SPLIT)), 1)
    return -(-(-(-cap // n)) // TILE) * TILE


def scratch_bytes(B: int, H: int, K: int, cap: int, hd: int,
                  sms: int = H100_SMS) -> int:
    """The kernel's float32 scratch: the scores (B, H, cap), padded to 64
    floats, then the splits' partial sums (B, H, n_split, hd) when there is
    more than one split."""
    n_split = -(-cap // plan(B, K, H // K, cap, sms))
    part = B * H * n_split * hd if n_split > 1 else 0
    return 4 * (-(-B * H * cap // 64) * 64 + part)


def flops(B: int, H: int, cap: int, hd: int) -> int:
    """q.k and p.v over every slot of every query head, 2 * hd each: what
    ``FlopCounterMode`` counts for the plain version's two einsums."""
    return 4 * B * H * cap * hd


def io_bytes(B: int, cap: int, H: int, K: int, hd: int, itemsize: int,
             append: bool = False) -> int:
    """Bytes the kernel must move: K and V once, q and the output, the
    int32 slot positions and current positions; with ``append``, this
    token's K and V rows read and written into the caches."""
    rows = 4 * B * K * hd if append else 0
    return (2 * B * cap * K * hd + 2 * B * H * hd + rows) * itemsize \
        + 4 * B * cap + 4 * B


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, kv_positions: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token against a KV cache.

    q (B,1,H,hd); cache_k/v (B,cap,K,hd), query head h reads KV head h // G;
    kv_positions (B,cap) int32, -1 for an empty slot; pos (B,) int32, the
    current position; a slot attends when ``0 <= kv_pos <= pos`` (and
    ``kv_pos > pos - window`` with a window).  ``k_new`` / ``v_new``
    (B,1,K,hd), if given, are written into slot ``pos % cap`` of the caches
    first (in place).  q, the caches and the new rows of one dtype (float32
    or bfloat16), all contiguous, on one device; hd a multiple of 8, at most
    256 in bfloat16 and 128 in float32.  ``scale``, the softmax scale
    (default ``1/sqrt(hd)``), multiplies q in its dtype, rounded to it.
    Returns (B,1,H,hd) in q's dtype.
    """
    _check(q, cache_k, cache_v, kv_positions, pos, window, k_new, v_new)
    if q.device.type == "cpu" and not dryrun.active():
        if k_new is not None:
            ref.write(cache_k.shape[1], 0, (cache_k, cache_v),
                      (k_new[:, 0], v_new[:, 0]), pos)
        return ref.decode_attention(q, cache_k, cache_v, kv_positions, pos,
                                    window=window, scale=scale)
    if _obs.enabled:
        _obs.count(COUNT, 1)
    return torch.ops.repro_torch.decode_attention(
        q, cache_k, cache_v, kv_positions, pos, window, k_new, v_new, scale)


def _sm_count(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


@torch.library.custom_op("repro_torch::decode_attention",
                         mutates_args=("cache_k", "cache_v"),
                         device_types="cuda")
def _decode_op(q: Tensor, cache_k: Tensor, cache_v: Tensor,
               kv_positions: Tensor, pos: Tensor, window: Optional[int],
               k_new: Optional[Tensor], v_new: Optional[Tensor],
               scale: Optional[float] = None) -> Tensor:
    """One entry point: the scores kernel (after writing the new rows, when
    given), the p.v kernel, and the combine when the slots are split.  The
    caches change only where the new rows go."""
    B, _, H, hd = q.shape
    cap, K = cache_k.shape[1], cache_k.shape[2]
    scale = ref.default_scale(hd) if scale is None else scale
    sms = _sm_count(q.device)
    split = plan(B, K, H // K, cap, sms)
    out = torch.empty_like(q)
    scratch = torch.empty(scratch_bytes(B, H, K, cap, hd, sms) // 4,
                          dtype=torch.float32, device=q.device)
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, f"ksp_decode_attention_{_SUFFIX[q.dtype]}", q.device,
                 q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                 None if k_new is None else k_new.data_ptr(),
                 None if v_new is None else v_new.data_ptr(),
                 kv_positions.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B, cap, H, K, hd, window or 0, split,
                 scale)
    LAUNCHES["decode_attention"] += 1
    return out


@_decode_op.register_fake
def _decode_fake(q, cache_k, cache_v, kv_positions, pos, window, k_new,
                 v_new, scale=None):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    B, _, H, hd = q_shape
    return flops(B, H, k_shape[1], hd)
