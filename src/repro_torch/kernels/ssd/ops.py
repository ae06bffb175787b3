"""Wrapper of the SSD kernel: checks, routing and the launch count.

:func:`ssd` is the port's counterpart of the reference's
``models/mamba2.py::ssd_chunked`` and of its Pallas drop-in
``kernels/ssd/ops.py::ssd_pallas``, in the model layout.  A tensor on the
CPU goes to the plain version (:mod:`repro_torch.kernels.ssd.ref`); a
tensor on CUDA goes to the hand-written kernel (``csrc/ssd.cu``) or raises.
``LAUNCHES["ssd"]`` counts kernel launches and nothing else.

The kernel carries the state every ``SUB_CHUNK`` = 64 rows, whatever the
model's ``chunk``: the scan's result does not depend on the chunk size
(``tests/test_models.py::test_mamba_chunk_invariance``), and 64 rows keep
the working set in shared memory (see the source).  The plain version
chunks by ``chunk``.  The kernel reads ragged tails as zeros, so nothing is
padded.  The scan starts from a zero state: the reference's
``initial_state`` argument has no caller in either package and is not
carried over.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

__all__ = ["LAUNCHES", "SOURCE", "SUB_CHUNK", "reset_launches", "ssd"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
SUB_CHUNK = 64        # kSub in csrc/ssd.cu
MAX_P = MAX_N = 128   # kMaxP / kMaxN in csrc/ssd.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
# (x, a, b, c, y, final, B, S, H, P, G, N, stream)
_ARGS = [_P] * 6 + [_I] * 6 + [_P]
SIGNATURES = {"ksp_ssd_f32": _ARGS, "ksp_ssd_bf16": _ARGS}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

LAUNCHES = {"ssd": 0}


def reset_launches() -> None:
    LAUNCHES["ssd"] = 0


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
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")
    return B, S, H, P, G, N


def ssd(X: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int):
    """Chunked SSD scan in the model layout.

    X: (B,S,H,P) inputs pre-multiplied by dt; A: (B,S,H) log-decay
    increments; Bm/Cm: (B,S,G,N), head h reads group h // (H/G); all of one
    dtype (float32 or bfloat16), contiguous, on one device.
    Returns ``(Y (B,S,H,P) in X's dtype, final_state (B,H,P,N) float32)``.
    """
    B, S, H, P, G, N = _check(X, A, Bm, Cm, chunk)
    if X.device.type == "cpu":
        return ref.ssd(X, A, Bm, Cm, chunk)
    y = torch.empty_like(X)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=X.device)
    lib = build.load(SOURCE, SIGNATURES)
    build.launch(lib, f"ksp_ssd_{_SUFFIX[X.dtype]}", X.device,
                 X.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), final.data_ptr(), B, S, H, P, G, N)
    LAUNCHES["ssd"] += 1
    return y, final
