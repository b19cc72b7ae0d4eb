"""RMSNorm: the wrapper of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_pallas``.  A tensor on the CPU
takes the plain version (``ref.rmsnorm``); a tensor on the card launches
the kernel, or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import DTYPE_CODES, CudaKernel, stream_of

__all__ = ["rmsnorm", "KERNEL"]

KERNEL = CudaKernel(
    "rmsnorm.cu", "repro_rmsnorm",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm scale dtype {scale.dtype} != x dtype {x.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm scale shape {tuple(scale.shape)} does not match "
                         f"x's last dim in {tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous x and scale")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm x on {x.device}, scale on {scale.device}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps))`` rounded to x's dtype, times ``scale``,
    over the last dim of ``x``."""
    _check(x, scale)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    KERNEL.launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
                  DTYPE_CODES[x.dtype], x.device.index, stream_of(x))
    return out
