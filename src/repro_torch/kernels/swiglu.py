"""Fused SwiGLU, ``silu(gate) * up``: the wrapper of ``csrc/swiglu.cu``.

Replaces ``repro/kernels/swiglu.py:swiglu_pallas``.  A tensor on the CPU
takes the plain version (``ref.swiglu``); a tensor on the card launches the
kernel, or the call raises; a DTensor runs on its local shard
(``local.call_local``).  Under grad mode the launch is differentiable
through the plain version's vjp (``autograd.kernel_call``).
"""
from __future__ import annotations

import ctypes

import torch

from ..tree import is_dtensor
from . import ref
from .autograd import kernel_call
from .build import DTYPE_CODES, CudaKernel, stream_of
from .local import call_local, swiglu_rule

__all__ = ["swiglu", "KERNEL"]

KERNEL = CudaKernel(
    "swiglu.cu", "repro_swiglu",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def _check(gate: torch.Tensor, up: torch.Tensor) -> None:
    if gate.dtype not in DTYPE_CODES:
        raise TypeError(f"swiglu takes float32 or bfloat16, got {gate.dtype}")
    if up.dtype != gate.dtype:
        raise TypeError(f"swiglu up dtype {up.dtype} != gate dtype {gate.dtype}")
    if up.shape != gate.shape:
        raise ValueError(f"swiglu shapes differ: {tuple(gate.shape)} vs {tuple(up.shape)}")
    if not (gate.is_contiguous() and up.is_contiguous()):
        raise ValueError("swiglu takes contiguous gate and up")
    if up.device != gate.device:
        raise ValueError(f"swiglu gate on {gate.device}, up on {up.device}")


def _launch(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(gate)
    n = gate.numel()
    if n == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (gate, up, out))
    KERNEL.launch(gate.data_ptr(), up.data_ptr(), out.data_ptr(), n, int(aligned),
                  DTYPE_CODES[gate.dtype], gate.device.index, stream_of(gate))
    return out


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in f32, returned in gate's dtype.  DTensors run on
    their local shards (``local.swiglu_rule``)."""
    if is_dtensor(gate):
        return call_local(swiglu, swiglu_rule, (gate, up), (gate.shape,), "swiglu")
    _check(gate, up)
    if gate.device.type == "cpu":
        return ref.swiglu(gate, up)
    if gate.device.type != "cuda":
        raise ValueError(f"swiglu runs on cpu or cuda, not {gate.device}")
    return kernel_call(_launch, ref.swiglu, gate, up)
