"""RMSNorm: the wrapper of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_pallas``.  A tensor on the CPU
takes the plain version (``ref.rmsnorm``); a tensor on the card launches
the kernel, or the call raises; a DTensor runs on its local shard
(``local.call_local``).  Under grad mode the launch is
differentiable through the plain version's vjp (``autograd.kernel_call``).
"""
from __future__ import annotations

import ctypes

import torch

from ..tree import is_dtensor
from . import ref
from .autograd import kernel_call
from .build import DTYPE_CODES, CudaKernel, stream_of
from .local import call_local, rmsnorm_rule

__all__ = ["rmsnorm", "KERNEL", "MAX_CHUNKS"]

#: 16-byte chunks of a row the kernel holds in registers: 4 per thread, at
#: most 1024 threads a row (d up to 32768 in bf16, 16384 in f32)
MAX_CHUNKS = 4 * 1024

KERNEL = CudaKernel(
    "rmsnorm.cu", "repro_rmsnorm",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
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


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    if -(-d * x.element_size() // 16) > MAX_CHUNKS:
        raise ValueError(f"rmsnorm on the card takes rows of at most {16 * MAX_CHUNKS} "
                         f"bytes, got d={d} in {x.dtype}")
    # 16-byte loads need every row, the scale and the output on 16-byte bounds
    vector = (d * x.element_size()) % 16 == 0 and (
        (x.data_ptr() | scale.data_ptr() | out.data_ptr()) % 16 == 0)
    KERNEL.launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
                  int(vector), DTYPE_CODES[x.dtype], x.device.index, stream_of(x))
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps))`` rounded to x's dtype, times ``scale``,
    over the last dim of ``x``.  A DTensor runs on its local rows
    (``local.rmsnorm_rule``)."""
    if is_dtensor(x):
        return call_local(lambda xl, sl: rmsnorm(xl, sl, eps=eps), rmsnorm_rule, (x, scale),
                          (x.shape,), "rmsnorm")
    _check(x, scale)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
    return kernel_call(_launch, ref.rmsnorm, x, scale, eps)
