"""GQA attention block: RoPE, optional qk-norm / QKV bias, KV cache.

The counterpart of ``repro/models/attention.py``: the one-device block
and the explicit tensor-parallel output projections (``attention_tp_out``,
``attention_tp_out_sp``), whose combines the active ``comm_context`` plans.
Prefill runs the flash path (``kernels.ops.flash_attention``: the CUDA
kernel on the card); decode attends one query against the padded cache
with a position mask, on the plain path in both packages.

Unlike the reference, which returns a new cache, the KV cache is written
in place: the ``(B, Hkv, T, hd)`` views handed in are updated and returned.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..comms import api
from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_rope, dense, dense_init, rmsnorm, rmsnorm_init

__all__ = ["attn_init", "attention_heads", "attention", "attention_tp_out",
           "attention_tp_out_sp"]

KVCache = Tuple[torch.Tensor, torch.Tensor]


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
              device: torch.device) -> Dict:
    out_scale = 0.02 / (2 * cfg.num_layers) ** 0.5
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, scale=out_scale, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, **kw)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, **kw)
    return p


def attention_heads(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    positions: torch.Tensor,  # (B, S) absolute positions
    kv_cache: Optional[KVCache] = None,  # (B, Hkv, T, hd) x2, written in place
    cache_pos: int = 0,  # position being written
    qkv: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """QKV, RoPE and attention, up to (not including) the output
    projection.  Returns the (B, S, H*hd) head outputs and the cache.

    ``qkv`` optionally supplies precomputed (pre-reshape) projections: the
    SP path computes them fused with the sequence all-gather
    (``api.allgather_matmul``) and hands them in here."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    if qkv is None:
        q, k, v = dense(p["wq"], x), dense(p["wk"], x), dense(p["wv"], x)
    else:
        q, k, v = qkv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    # the kernel takes contiguous (B, H, S, hd)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()

    if kv_cache is None:
        out = ops.flash_attention(qh, kh, vh, causal=cfg.causal)
        new_cache = None
    else:
        ck, cv = kv_cache
        T = ck.shape[2]
        # lax.dynamic_update_slice semantics: the start is clamped so the
        # block fits
        start = min(max(int(cache_pos), 0), T - S)
        ck[:, :, start:start + S] = kh.to(ck.dtype)
        cv[:, :, start:start + S] = vh.to(cv.dtype)
        new_cache = (ck, cv)
        if S > 1:
            # prefill: the new block is the whole context, attended causally
            # within itself; the cache write above installs the state
            out = ops.flash_attention(qh, kh, vh, causal=cfg.causal)
        else:
            # decode: one query against the valid prefix of the cache
            valid = torch.arange(T, device=x.device)[None, :] <= int(cache_pos)
            out = ops.flash_attention(qh, ck, cv, causal=False,
                                      kv_mask=valid.expand(B, T))

    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out, new_cache


def attention(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    kv_cache: Optional[KVCache] = None,
    cache_pos: int = 0,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    out, new_cache = attention_heads(
        p, cfg, x, positions=positions, kv_cache=kv_cache, cache_pos=cache_pos)
    return dense(p["wo"], out), new_cache


def attention_tp_out(
    p: Dict,
    out_local: torch.Tensor,  # (B, S, local_q_dim): this rank's heads
    axis_names: Optional[Sequence[str]] = None,
    *,
    num_chunks: Optional[int] = None,
    ctx=None,
) -> torch.Tensor:
    """Explicit tensor-parallel output projection on this rank's heads.

    Heads are sharded over the context axes; ``p["wo"]`` holds the matching
    rows, so the local matmul is a partial sum over head shards, which the
    context-planned all-reduce combines.  ``axis_names``/``num_chunks``
    are legacy overrides.
    """
    partial = dense(p["wo"], out_local)
    return api.all_reduce(partial, axis=-1, ctx=ctx, axes=axis_names,
                          num_chunks=api.legacy_chunks(num_chunks))


def attention_tp_out_sp(
    p: Dict,
    out_local: torch.Tensor,  # (B, S, local_q_dim): this rank's heads
    axis_names: Optional[Sequence[str]] = None,
    *,
    seq_axis: int = 1,
    fuse: object = None,
    ctx=None,
) -> torch.Tensor:
    """Sequence-parallel TP output projection on this rank's heads.

    Like ``attention_tp_out`` but combining back to *sequence shards*:
    ``psum_scatter(out_local @ wo)`` along ``seq_axis``, planned and (when
    the overlap model wins) fused per block by the context
    (``api.matmul_reduce_scatter``).  A wo bias, if present, is added once
    to the scattered output, never into the partial sums.
    """
    out = api.matmul_reduce_scatter(out_local, p["wo"]["w"], axis=seq_axis,
                                    axes=axis_names, ctx=ctx, fuse=fuse)
    if "b" in p["wo"]:
        out = out + p["wo"]["b"]
    return out
