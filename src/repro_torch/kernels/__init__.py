"""Hand-written Hopper kernels for the package's hot spots.

* ``wastage`` — KS+ fleet-scale OOM probe and success wastage
  (``csrc/wastage.cu``);
* ``ssd`` — the Mamba2 chunked SSD scan (``csrc/ssd.cu``);
* ``flash_attention`` — causal / windowed GQA attention forward
  (``csrc/flash_attention.cu``);
* ``decode_attention`` — one query token against the KV cache, read once
  in place (``csrc/decode_attention.cu``);
* ``admission`` — the cluster's float64 admission programs: the fits
  columns and a whole greedy drain in one launch (``csrc/admission.cu``);
* ``mamba2_mix`` — the Mamba2 prefill mixer's elementwise work on either
  side of the SSD scan (``csrc/mamba2_mix.cu``).

All six are CUDA C++ for ``sm_90a``.  Each kernel ships ``csrc/`` (the
CUDA source), ``ops.py`` (the checked wrapper with its launch count) and
``ref.py`` (the plain PyTorch version, used for CPU tensors and as the
kernel's oracle); :mod:`repro_torch.kernels.build` compiles each source with
``nvcc`` into ``build/repro_torch_kernels/`` and loads it with ``ctypes`` at
its first launch.  The LM kernels' launches are custom operators with
fake implementations and FLOP rules; :mod:`repro_torch.kernels.dryrun`
is the dry run's switch to them.
"""
