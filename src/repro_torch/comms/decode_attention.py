"""Sharded-KV decode attention (flash-decoding style two-pass combine).

When a KV cache is *sequence*-sharded (the layout for a kv-head count that
does not divide the TP axis), each rank holds a contiguous slice of the
keys and values.  Decode attention then runs in two passes:

  1. locally: partial online-softmax statistics over the rank's slice
     (max m_i, denominator l_i, weighted accumulator o_i);
  2. globally: a log-sum-exp-weighted combine across the axis, three small
     collectives (a max and two sums of (B, H[, hd])-sized tensors) instead
     of gathering the full cache.

The two sum combines route through the context-scoped collectives API
(``api.all_reduce``): they plan through the innermost ``comm_context`` and
hit its plan cache like every other collective; head counts that do not
divide the axis take the flat sum inside the api op.  The max is a scalar
combine, not gather-shaped, and is one ``FactorizedMesh.pmax``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sharded_decode_attention"]


def sharded_decode_attention(
    q: torch.Tensor,  # (B, H, 1, hd), the same on every rank of the axis
    k_shard: torch.Tensor,  # (B, Hkv, T_local, hd), this rank's KV slice
    v_shard: torch.Tensor,
    *,
    axis_name: str,
    valid_len: int,  # global number of valid cache positions
    scale: Optional[float] = None,
    ctx=None,
) -> torch.Tensor:
    """Attention of one query against an axis-sharded KV cache; the mesh
    comes from ``ctx`` or the innermost ``comm_context``."""
    from . import api  # local: api imports the executors lazily too

    c = ctx if ctx is not None else api.current_context()
    mesh = api._require_mesh(c, "sharded_decode_attention")
    B, H, _, hd = q.shape
    Hkv, T_local = k_shard.shape[1], k_shard.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)

    start = mesh.axis_index(axis_name) * T_local
    pos = start + torch.arange(T_local, device=q.device)  # global key positions
    valid = pos < int(valid_len)  # (T_local,)

    kx = k_shard.repeat_interleave(rep, dim=1).float()
    vx = v_shard.repeat_interleave(rep, dim=1).float()
    q32 = q[:, :, 0].float()  # (B, H, hd)

    s = torch.einsum("bhd,bhtd->bht", q32, kx) * scale  # (B, H, T_local)
    s = s.masked_fill(~valid, -torch.inf)

    m_local = s.max(dim=-1).values  # (B, H)
    # guard all-invalid shards
    m_safe = torch.where(torch.isfinite(m_local), m_local, torch.full_like(m_local, -1e30))
    p = torch.exp(s - m_safe[..., None]).masked_fill(~valid, 0.0)
    l_local = p.sum(dim=-1)  # (B, H)
    o_local = torch.einsum("bht,bhtd->bhd", p, vx)  # (B, H, hd)

    # two-pass combine across the axis: the sums are context-planned
    # (staged AR when the combined dim divides the axis, flat sum otherwise)
    m_global = mesh.pmax(m_safe, axis_name)  # (B, H)
    alpha = torch.exp(m_safe - m_global)
    l_global = api.all_reduce(l_local * alpha, axes=(axis_name,), ctx=c)
    o_global = api.all_reduce(o_local * alpha[..., None], axes=(axis_name,), ctx=c)
    l_global = torch.where(l_global == 0.0, torch.ones_like(l_global), l_global)
    out = o_global / l_global[..., None]
    return out[:, :, None, :].to(q.dtype)  # (B, H, 1, hd)
