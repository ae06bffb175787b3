"""KS+ in PyTorch for an NVIDIA H100: the port of the ``repro`` package.

The layout mirrors ``repro`` module for module (``repro_torch.core.fleet``
↔ ``repro.core.fleet``, ...) and imports nothing of it.  Entry points take
``device=None``, which means the card; the plain PyTorch path runs on the
CPU when asked for with ``device="cpu"``.  The hand-written CUDA kernels
live under :mod:`repro_torch.kernels` and are built at first launch.
"""
