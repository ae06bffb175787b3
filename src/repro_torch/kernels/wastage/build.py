"""Build and load the wastage kernels' shared library.

``nvcc`` compiles ``csrc/wastage.cu`` (a plain C interface, no PyTorch
headers, so it builds in seconds) into ``build/repro_torch_kernels/`` at
the root of the source checkout, named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads the cached
library.  The package must run from its checkout (``src/`` layout, e.g.
``PYTHONPATH=src`` or an editable install): an installed copy has no
checkout to build into and raises.  Nothing is built or loaded at import:
the first CUDA launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCE", "NVCC_FLAGS", "build_dir", "build", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "wastage.cu"
# No --use_fast_math: violation indices depend on IEEE float32 compares.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {home}")
    return str(path)


def build_dir() -> Path:
    """``build/repro_torch_kernels/`` at the root of the source checkout."""
    # <root>/src/repro_torch/kernels/wastage/build.py
    src = Path(__file__).resolve().parents[3]
    root = src.parent
    if src.name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(
            f"{__file__} is not inside a source checkout (<root>/src/ with "
            "<root>/pyproject.toml); run repro_torch from its checkout so "
            "the kernels build into <root>/build/")
    return root / "build" / "repro_torch_kernels"


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libksp_wastage_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless the cached one matches the source.

    Returns ``(path, seconds spent compiling)`` — 0.0 on a cache hit.
    """
    path = _lib_path()
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded library with its C signatures declared (built if needed)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ksp_oom_probe.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, f32,
                                      ptr, ptr, ptr, ptr]
        lib.ksp_oom_probe.restype = i32
        lib.ksp_wastage_eval.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                         f32, ptr, ptr]
        lib.ksp_wastage_eval.restype = i32
        _lib = lib
    return _lib
