"""WKV6 recurrence, the RWKV6 time-mix scan: the wrapper of ``csrc/wkv6.cu``.

Replaces ``repro/kernels/rwkv6_scan.py:rwkv6_scan_pallas``.  A tensor on the
CPU takes the plain version (``ref.rwkv6_scan``); a tensor on the card
launches the kernel, or the call raises; a DTensor runs on its local
shard (``local.call_local``).  Under grad mode the launch is
differentiable through the plain version's vjp (``autograd.kernel_call``).
The kernel takes every sequence length, 1 (decode) included: the
reference's fallback to its oracle when ``S`` is not a multiple of the
Pallas chunk exists only for the TPU's block shapes and has no counterpart
here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..tree import is_dtensor
from . import ref
from .autograd import kernel_call
from .build import DTYPE_CODES, CudaKernel, stream_of
from .local import call_local, wkv6_rule

__all__ = ["rwkv6_scan", "KERNEL", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)

KERNEL = CudaKernel(
    "wkv6.cu", "repro_wkv6",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, state: Optional[torch.Tensor]) -> None:
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"rwkv6_scan takes float32 or bfloat16, got {r.dtype}")
    if any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"rwkv6_scan dtypes differ: r {r.dtype}, k {k.dtype}, "
                        f"v {v.dtype}, w {w.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_scan takes r, k, v, w of one shape (B,H,S,hd); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, S, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan head_dim {hd} not in {HEAD_DIMS}")
    if u.dtype != torch.float32 or u.shape != (H, hd):
        raise ValueError(f"rwkv6_scan takes u as ({H},{hd}) float32, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if state is not None and (state.dtype != torch.float32 or state.shape != (B, H, hd, hd)):
        raise ValueError(f"rwkv6_scan takes state as ({B},{H},{hd},{hd}) float32, got "
                         f"{tuple(state.shape)} {state.dtype}")
    tensors = (r, k, v, w, u) + (() if state is None else (state,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rwkv6_scan takes contiguous r, k, v, w, u and state")
    if any(t.device != r.device for t in tensors):
        raise ValueError(f"rwkv6_scan tensors on {sorted({str(t.device) for t in tensors})}")


def rwkv6_scan(
    r: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, H, S, hd)
    v: torch.Tensor,  # (B, H, S, hd)
    w: torch.Tensor,  # (B, H, S, hd) decay in (0, 1)
    u: torch.Tensor,  # (H, hd) float32
    state: Optional[torch.Tensor] = None,  # (B, H, hd, hd) float32; None: zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence from ``state``; returns (y (B,H,S,hd) in r's
    dtype, the final state (B,H,hd,hd) in float32).  ``state`` is read,
    never written.  DTensors run on their local shards
    (``local.wkv6_rule``)."""
    if is_dtensor(r):
        B, H, _, hd = r.shape
        return call_local(rwkv6_scan, wkv6_rule, (r, k, v, w, u, state),
                          (r.shape, (B, H, hd, hd)), "rwkv6_scan")
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return ref.rwkv6_scan(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not {r.device}")
    return kernel_call(_launch, ref.rwkv6_scan, r, k, v, w, u, state)


def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, S, hd = r.shape
    s0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if state is None else state)
    y = torch.empty_like(r)
    s_final = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, s_final
    KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                  s0.data_ptr(), y.data_ptr(), s_final.data_ptr(), B * H, H, S, hd,
                  DTYPE_CODES[r.dtype], r.device.index, stream_of(r))
    return y, s_final
