"""Hand-written Hopper kernels for the package's hot spots.

* ``wastage`` — KS+ fleet-scale OOM probe and success wastage
  (``csrc/wastage.cu``, CUDA C++ for ``sm_90a``).

Each kernel ships ``csrc/`` (the CUDA source), ``build.py`` (``nvcc`` into
``build/repro_torch_kernels/``, loaded with ``ctypes`` at first launch),
``ops.py`` (the checked wrapper with its launch count) and ``ref.py`` (the
plain PyTorch version, used for CPU tensors and as the kernel's oracle).
"""
