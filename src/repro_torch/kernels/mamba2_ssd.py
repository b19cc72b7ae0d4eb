"""Mamba2 SSD recurrence, zamba2's time scan: the wrapper of ``csrc/mamba2_ssd.cu``.

Replaces ``repro/kernels/mamba2_scan.py:mamba2_ssd_pallas``.  A tensor on
the CPU takes the plain version (``ref.mamba2_ssd_scan``); a tensor on the
card launches the kernel, or the call raises; a DTensor runs on its local
shard (``local.call_local``).  Under grad mode the launch
is differentiable through the plain version's vjp
(``autograd.kernel_call``).  The kernel takes every sequence length, 1
(decode) included, where the Pallas wrapper refuses ``S`` that is not a
multiple of its chunk: that rule exists only for the TPU's block shapes and
has no counterpart here.

x, B and C may be strided views, as the model's split of one ``(B, S,
d_in + 2N)`` buffer gives them: the kernel reads them through their batch
and time strides, so no copy is made.  Each needs its innermost dim
contiguous, and x each time step's ``(H, P)`` block contiguous.

The one C entry picks one of three kernels by a rule written in the
source's note (:func:`route` asks the built library which): ``decode`` at
S 1, ``chunked`` (the SSD chunk form on tensor cores) for bf16 with P and N
multiples of 16, ``sequential`` (one thread per state row) otherwise.
Every call is one launch whichever it takes.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..tree import is_dtensor
from . import ref
from .autograd import kernel_call
from .build import DTYPE_CODES, CudaKernel, stream_of
from .local import call_local, ssd_rule

__all__ = ["mamba2_ssd_scan", "route", "KERNEL", "STATE_DIMS", "MAX_HEAD_DIM", "ROUTES"]

#: state dims N the kernel is instantiated for
STATE_DIMS = (8, 16, 32, 64)
#: largest head dim P: one thread per state row
MAX_HEAD_DIM = 128

KERNEL = CudaKernel(
    "mamba2_ssd.cu", "repro_mamba2_ssd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


#: the kernels behind the entry, by the code ``repro_mamba2_ssd_route`` returns
ROUTES = ("sequential", "decode", "chunked")


def route(S: int, P: int, N: int, dtype: torch.dtype) -> str:
    """The kernel a call with these sizes and input dtype launches, as the
    built library decides it (so on a machine with ``nvcc`` only)."""
    fn = KERNEL.function("repro_mamba2_ssd_route", [ctypes.c_int] * 4)
    return ROUTES[fn(S, P, N, DTYPE_CODES[dtype])]


def _check(x: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor, decay: torch.Tensor,
           dt: torch.Tensor, state: Optional[torch.Tensor]) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"mamba2_ssd_scan takes float32 or bfloat16, got {x.dtype}")
    if Bmat.dtype != x.dtype or Cmat.dtype != x.dtype:
        raise TypeError(f"mamba2_ssd_scan dtypes differ: x {x.dtype}, B {Bmat.dtype}, "
                        f"C {Cmat.dtype}")
    if x.dim() != 4:
        raise ValueError(f"mamba2_ssd_scan takes x as (B,S,H,P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bmat.shape[-1] if Bmat.dim() == 3 else -1
    if Bmat.shape != (B, S, N) or Cmat.shape != (B, S, N):
        raise ValueError(f"mamba2_ssd_scan takes B and C as ({B},{S},N), got "
                         f"{tuple(Bmat.shape)}, {tuple(Cmat.shape)}")
    if not 1 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"mamba2_ssd_scan head_dim {P} not in [1, {MAX_HEAD_DIM}]")
    if N not in STATE_DIMS:
        raise ValueError(f"mamba2_ssd_scan state_dim {N} not in {STATE_DIMS}")
    for name, t in (("decay", decay), ("dt", dt)):
        if t.dtype != torch.float32 or t.shape != (B, S, H):
            raise ValueError(f"mamba2_ssd_scan takes {name} as ({B},{S},{H}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if state is not None and (state.dtype != torch.float32 or state.shape != (B, H, P, N)):
        raise ValueError(f"mamba2_ssd_scan takes state as ({B},{H},{P},{N}) float32, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if x.stride(3) != 1 or x.stride(2) != P or Bmat.stride(2) != 1 or Cmat.stride(2) != 1:
        raise ValueError("mamba2_ssd_scan takes x with each time step's (H, P) block "
                         "contiguous, and B and C contiguous in their last dim")
    tensors = (x, Bmat, Cmat, decay, dt) + (() if state is None else (state,))
    if not all(t.is_contiguous() for t in tensors[3:]):
        raise ValueError("mamba2_ssd_scan takes contiguous decay, dt and state")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"mamba2_ssd_scan tensors on {sorted({str(t.device) for t in tensors})}")


def mamba2_ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    Bmat: torch.Tensor,  # (B, S, N), shared across heads
    Cmat: torch.Tensor,  # (B, S, N), shared across heads
    decay: torch.Tensor,  # (B, S, H) float32
    dt: torch.Tensor,  # (B, S, H) float32
    state: Optional[torch.Tensor] = None,  # (B, H, P, N) float32; None: zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence from ``state``; returns (y (B,S,H,P) float32, the
    final state (B,H,P,N) float32).  ``state`` is read, never written.
    DTensors run on their local shards (``local.ssd_rule``)."""
    if is_dtensor(x):
        B, _, H, P = x.shape
        return call_local(mamba2_ssd_scan, ssd_rule, (x, Bmat, Cmat, decay, dt, state),
                          (x.shape, (B, H, P, Bmat.shape[-1])), "mamba2_ssd_scan")
    _check(x, Bmat, Cmat, decay, dt, state)
    if x.device.type == "cpu":
        return ref.mamba2_ssd_scan(x, Bmat, Cmat, decay, dt, state)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd_scan runs on cpu or cuda, not {x.device}")
    return kernel_call(_launch, ref.mamba2_ssd_scan, x, Bmat, Cmat, decay, dt, state)


def _launch(x: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor, decay: torch.Tensor,
            dt: torch.Tensor, state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    s0 = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
          if state is None else state)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    s_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, s_final
    KERNEL.launch(x.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), decay.data_ptr(),
                  dt.data_ptr(), s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
                  B, H, S, P, N, x.stride(0), x.stride(1), Bmat.stride(0), Bmat.stride(1),
                  Cmat.stride(0), Cmat.stride(1), DTYPE_CODES[x.dtype], x.device.index,
                  stream_of(x))
    return y, s_final
