"""PyTorch/CUDA port of the ``repro`` model stack for one NVIDIA H100.

The layout mirrors ``repro`` (``configs``, ``kernels``, ``models``,
``runtime``, ``launch``) so each module's JAX counterpart is easy to find.
The package imports torch and numpy, never jax or ``repro``: what it needs
from the reference is copied.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU each kernel wrapper takes its
plain PyTorch version, on the card it launches its hand-written kernel.
"""
