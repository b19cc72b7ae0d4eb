"""Feed-forward blocks: SwiGLU (default) and GELU (hubert/w2v2).

The counterpart of ``repro/models/mlp.py``.  ``ffn_apply`` is the
one-device form; ``ffn_apply_tp`` / ``ffn_apply_tp_sp`` are the explicit
tensor-parallel forms, run on each rank's local slice with every
collective decision (stage order, mode, chunking, collective-matmul
fusion) taken by the active :class:`repro_torch.comms.api.CommContext`.
SwiGLU goes through ``kernels.ops.swiglu``: the CUDA kernel on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..comms import api
from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense, dense_init

__all__ = ["ffn_init", "ffn_apply", "ffn_apply_tp", "ffn_apply_tp_sp", "plan_tp_fusion",
           "mlp_init", "mlp"]


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, num_layers: int, *,
             dtype: torch.dtype, device: torch.device, kind: str = "swiglu") -> Dict:
    down_scale = 0.02 / (2 * num_layers) ** 0.5
    kw = dict(dtype=dtype, device=device)
    if kind == "swiglu":
        return {
            "gate": dense_init(gen, d_model, d_ff, **kw),
            "up": dense_init(gen, d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, d_model, scale=down_scale, **kw),
        }
    if kind == "gelu":
        return {
            "up": dense_init(gen, d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, d_model, scale=down_scale, **kw),
        }
    raise ValueError(kind)


def _gelu(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(u.float(), approximate="tanh").to(dtype)


def ffn_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "gate" in p:
        h = ops.swiglu(dense(p["gate"], x), dense(p["up"], x))
    else:
        h = _gelu(dense(p["up"], x), x.dtype)
    return dense(p["down"], h)


def ffn_apply_tp(
    p: Dict,
    x: torch.Tensor,
    axis_names: Optional[Sequence[str]] = None,
    *,
    num_chunks: Optional[int] = None,
    ctx=None,
) -> torch.Tensor:
    """Explicit tensor-parallel FFN body on this rank's slice.

    ``p`` holds this rank's slice of the hidden dim: gate/up are
    column-parallel (local d_ff columns), down is row-parallel (matching
    d_ff rows).  The down-projection therefore yields a *partial* sum over
    hidden shards, which the context-planned all-reduce combines.
    ``axis_names``/``num_chunks`` are legacy overrides; by default the
    active :func:`repro_torch.comms.api.comm_context` supplies axes and
    policy.
    """
    partial = ffn_apply(p, x)
    return api.all_reduce(partial, axis=-1, ctx=ctx, axes=axis_names,
                          num_chunks=api.legacy_chunks(num_chunks))


def plan_tp_fusion(
    axis_names: Sequence[str],
    rows: int,
    d_in: int,
    d_out: int,
    itemsize: int,
    *,
    n_matmuls: int = 1,
) -> bool:
    """Collective-matmul fuse decision for one gather-adjacent projection.

    ``rows`` is the per-block row count (the scattered shard's worth),
    ``d_in @ d_out`` the projection, ``n_matmuls`` how many projections
    share one gather (SwiGLU gate+up = 2).  One implementation with the
    context ops: delegates to
    :meth:`repro_torch.comms.api.CommContext.decide_fuse` of the active
    context, whose links price the decision and whose mesh (or
    ``axis_sizes``) gives the axis sizes, where the reference reads its
    ambient ``shard_map`` axis env.  A caller with links of its own installs
    them with ``comm_context(links=...)``.
    """
    axis_names = tuple(axis_names)
    return api.current_context().decide_fuse(axis_names, rows, d_in, d_out, itemsize,
                                             n_matmuls=n_matmuls, fuse="auto")


def ffn_apply_tp_sp(
    p: Dict,
    x: torch.Tensor,
    axis_names: Optional[Sequence[str]] = None,
    *,
    seq_axis: int = 1,
    fuse: object = None,
    ctx=None,
) -> torch.Tensor:
    """Sequence-parallel explicit-TP FFN body on this rank's slice.

    ``x`` arrives *sequence-sharded* over the context axes (the SP
    residual-stream layout); ``p`` holds this rank's d_ff slice as in
    ``ffn_apply_tp``.  The TP all-gather of ``x`` and the gate/up matmuls
    share one context-planned gather (fused per hop when the overlap model
    wins: ``api.allgather_matmul``) and the down-projection feeds the
    reduce-scatter back to sequence shards just-in-time
    (``api.matmul_reduce_scatter``).  Returns this rank's sequence slice of
    the combined FFN output.

    ``fuse``: None (context policy, default ``"auto"``) / True / False /
    ``"auto"``.
    """
    up_w = p["up"]["w"]
    if "gate" in p:
        _, (g, u) = api.allgather_matmul(
            x, (p["gate"]["w"], up_w), axis=seq_axis, axes=axis_names,
            ctx=ctx, fuse=fuse)
        h = ops.swiglu(g, u)
    else:
        _, u = api.allgather_matmul(
            x, up_w, axis=seq_axis, axes=axis_names, ctx=ctx, fuse=fuse)
        h = _gelu(u, x.dtype)
    return api.matmul_reduce_scatter(
        h, p["down"]["w"], axis=seq_axis, axes=axis_names, ctx=ctx, fuse=fuse)


def mlp_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
             device: torch.device) -> Dict:
    kind = "gelu" if cfg.family == "audio" else "swiglu"
    return ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.num_layers, dtype=dtype,
                    device=device, kind=kind)


def mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return ffn_apply(p, x)
