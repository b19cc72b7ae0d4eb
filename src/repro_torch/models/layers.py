"""Shared building blocks (plain functions on dict params).

The counterpart of ``repro/models/layers.py``.  Dense weights keep the JAX
layout ``w: (d_in, d_out)``; normalisation and RoPE run in float32.
rmsnorm goes through ``kernels.ops`` so the card runs the hand-written
kernel; group_norm has no kernel in either package and stays plain.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import ops

__all__ = ["dense_init", "dense", "rmsnorm_init", "rmsnorm", "group_norm", "rope_freqs",
           "apply_rope"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, dtype: torch.dtype,
               device: torch.device, scale: Optional[float] = None,
               bias: bool = False) -> Dict[str, torch.Tensor]:
    scale = 0.02 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, *, dtype: torch.dtype, device: torch.device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps=eps)


def group_norm(x: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-group (e.g. per-head) normalisation over the last dim, no affine,
    in f32.  The variance is the population one (``correction=0``), as
    ``jnp.var`` takes it; ``torch.var``'s default would divide by n - 1."""
    *lead, d = x.shape
    g = x.reshape(*lead, num_groups, d // num_groups).float()
    mean = g.mean(dim=-1, keepdim=True)
    var = g.var(dim=-1, keepdim=True, correction=0)
    out = (g - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype).reshape(*lead, d)


# --------------------------------------------------------------------------
# RoPE (GPT-NeoX half-rotation)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
