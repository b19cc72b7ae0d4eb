"""Dispatch for the kernels on the serving paths, by the tensor's device.

The counterpart of ``repro/kernels/ops.py`` with its ``ref|pallas`` switch
replaced by the device: a CPU tensor takes the plain version, a CUDA tensor
the hand-written kernel (and a kernel that does not build or launch
raises).  The reference's routing rules stay as they are:

* attention with a ``kv_mask`` (decode against the padded cache) takes the
  plain masked path on every device, as ``ops.py:116`` does in the
  reference: no kernel is involved there in either package;
* on the CPU, prefill with more than ``FLASH_CHUNK_THRESHOLD`` keys takes
  the chunked online-softmax version, as the reference's ``ref`` backend.

``rwkv6_scan`` has no routing rule: the kernel takes every sequence
length, where the reference falls back to its oracle when ``S`` is not a
multiple of the Pallas chunk (``repro/kernels/ops.py:147``).

``mamba2_ssd_scan`` has none either: the kernel takes every sequence
length, 1 (decode) included.  The reference has no dispatch for it at all:
its Pallas wrapper refuses ``S`` that is not a multiple of its chunk
(``repro/kernels/mamba2_scan.py:76``), and the reference's Mamba2 block
never calls it, running the same recurrence in its own ``lax.scan``.  The
port's block calls this entry on every device.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention as _flash_attention_kernel
from .mamba2_ssd import mamba2_ssd_scan  # noqa: F401
from .rmsnorm import rmsnorm  # noqa: F401
from .swiglu import swiglu  # noqa: F401
from .wkv6 import rwkv6_scan  # noqa: F401

__all__ = ["rmsnorm", "swiglu", "flash_attention", "rwkv6_scan", "mamba2_ssd_scan",
           "FLASH_CHUNK_THRESHOLD", "FLASH_CHUNK"]

#: key length above which the plain path switches to the chunked
#: online-softmax attention (never materialises the S x T logits)
FLASH_CHUNK_THRESHOLD = 4096
FLASH_CHUNK = 1024


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    plain = kv_mask is not None or not q.is_cuda
    if plain and k.shape[2] > FLASH_CHUNK_THRESHOLD and q.shape[2] > 1:
        return ref.flash_attention_chunked(q, k, v, causal=causal, scale=scale,
                                           kv_mask=kv_mask, chunk=FLASH_CHUNK)
    if kv_mask is not None:
        return ref.flash_attention(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask)
    return _flash_attention_kernel(q, k, v, causal=causal, scale=scale)
