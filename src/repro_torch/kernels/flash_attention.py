"""Flash-attention forward: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``.  A
tensor on the CPU takes the plain version (``ref.flash_attention``); a
tensor on the card launches the kernel, or the call raises; a DTensor runs
on its local shard (``local.call_local``).  Under grad
mode the launch is differentiable through the plain version's vjp
(``autograd.kernel_call``).  The dtype chooses the kernel: bf16 runs on the
tensor cores and needs 16-byte-aligned q, k and v (the wrapper raises on
others rather than copy them); f32 runs on the CUDA cores.

Causal attention needs ``S == T`` on every device: the Pallas kernel aligns
query and key positions at 0 while the oracle offsets queries by ``T - S``,
and the serving path only ever has ``S == T``, so the wrapper refuses the
case rather than pick one meaning silently.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..tree import is_dtensor
from . import ref
from .autograd import kernel_call
from .build import DTYPE_CODES, CudaKernel, stream_of
from .local import call_local, flash_rule

__all__ = ["flash_attention", "KERNEL", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 80, 96, 128)

KERNEL = CudaKernel(
    "flash_attention.cu", "repro_flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention dtypes differ: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,H,S,hd) and k, v (B,Hkv,T,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    Bk, Hkv, T, hdk = k.shape
    if Bk != B or hdk != hd or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention head_dim {hd} not in {HEAD_DIMS}")
    if causal and S != T:
        raise ValueError(f"causal flash_attention needs S == T, got S={S}, T={T}")
    if B * H > 65535:
        raise ValueError(f"flash_attention B*H={B * H} exceeds the grid's y limit")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k and v")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention tensors on {q.device}, {k.device}, {v.device}")
    if q.is_cuda and q.dtype == torch.bfloat16 and (
            (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        raise ValueError("flash_attention on the card takes bf16 q, k and v at 16-byte "
                         "aligned addresses (its tiles are copied 16 bytes at a time)")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: Optional[float]) -> torch.Tensor:
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, H, Hkv, S, T, hd, float(scale), int(causal),
                  DTYPE_CODES[q.dtype], q.device.index, stream_of(q))
    return out


def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           scale: Optional[float]) -> torch.Tensor:
    return ref.flash_attention(q, k, v, causal=causal, scale=scale)


def flash_attention(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, Hkv, T, hd)
    v: torch.Tensor,  # (B, Hkv, T, hd)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention of q against k, v with GQA head mapping; returns
    (B, H, S, hd) in q's dtype.  DTensors run on their local shards
    (``local.flash_rule``)."""
    if is_dtensor(q):
        return call_local(lambda a, b, c: flash_attention(a, b, c, causal=causal, scale=scale),
                          flash_rule, (q, k, v), (q.shape,), "flash_attention")
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return kernel_call(_launch, _plain, q, k, v, causal, scale)
