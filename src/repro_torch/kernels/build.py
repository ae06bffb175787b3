"""Build and load the package's CUDA kernels, one shared library per source.

``nvcc`` compiles each ``csrc/*.cu`` (a plain C interface, no PyTorch
headers, so each builds in seconds) into ``build/repro_torch_kernels/`` at
the root of the source checkout, named by a hash of the source, the shared
headers of ``csrc/`` (``hopper.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one loads the cached library.  ``ptxas``
reports each kernel's registers, shared memory and spills (``-Xptxas -v``);
the report is kept beside the library (:func:`build_log`).  TMA's tensor
maps are encoded through the CUDA runtime's entry point into the CUDA
driver API, so nothing links against ``libcuda``.  The package must run
from its checkout (``src/`` layout, e.g. ``PYTHONPATH=src`` or an editable
install): an installed copy has no checkout to build into and raises.
Nothing is built or loaded at import: each kernel's first CUDA launch calls
:func:`load` for its source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "INCLUDE", "build_dir", "build", "build_all",
           "build_log", "check_tma", "load", "launch"]

# No --use_fast_math: violation indices depend on IEEE float32 compares, and
# the attention / SSD kernels are held to float32 tolerances of 2e-5.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# headers shared by the sources (Hopper's TMA / mbarrier / wgmma helpers)
INCLUDE = Path(__file__).resolve().parent / "csrc"

_libs: dict[Path, ctypes.CDLL] = {}


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
    # <root>/src/repro_torch/kernels/build.py
    src = Path(__file__).resolve().parents[2]
    root = src.parent
    if src.name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(
            f"{__file__} is not inside a source checkout (<root>/src/ with "
            "<root>/pyproject.toml); run repro_torch from its checkout so "
            "the kernels build into <root>/build/")
    return root / "build" / "repro_torch_kernels"


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(INCLUDE.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libksp_{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path) -> tuple[Path, float]:
    """Compile ``source`` unless the cached library matches it.

    Returns ``(path, seconds spent compiling)`` — 0.0 on a cache hit.
    """
    path = _lib_path(source)
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE), "-o", str(tmp),
         str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n"
            f"{proc.stderr}")
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def build_all(sources) -> dict[str, tuple[Path, float]]:
    """Build every source at once (one ``nvcc`` each, all started together).

    Returns ``{source stem: (path, seconds)}``; the first failure raises.
    """
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = [pool.submit(build, s) for s in sources]
        return {s.stem: f.result() for s, f in zip(sources, futures)}


def build_log(source: Path) -> str:
    """What ``nvcc`` and ``ptxas -v`` printed when ``source``'s library was
    built (registers, shared memory and spills of each kernel)."""
    return _lib_path(source).with_suffix(".log").read_text()


def check_tma(*widths: int, **tensors: torch.Tensor) -> None:
    """Raise unless TMA can load rows of these bf16 tensors: every row width
    a multiple of 8 elements (a 16-byte stride) and every base pointer
    16-byte aligned."""
    for w in widths:
        if w % 8:
            raise ValueError(f"the bf16 kernel loads rows with TMA and needs "
                             f"widths that are multiples of 8, got {w}")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for TMA")


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """The library of ``source`` with its C signatures declared (built if
    needed).  ``signatures`` maps each C function to its ``argtypes``; every
    function returns the launch's ``cudaError_t`` as an int."""
    lib = _libs.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def launch(lib: ctypes.CDLL, fn: str, device, *args) -> None:
    """Call the C entry point ``fn`` on ``device``'s current stream; raise
    if the launch was refused (the C side returns ``cudaGetLastError()``)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, cudaError {rc}")
