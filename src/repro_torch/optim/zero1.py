"""Explicit ZeRO-1 gradient sharding via the context-planned reduce-scatter.

The per-rank form for explicit data-parallel training loops: gradients are
reduce-scattered over the data axes through the active
:class:`repro_torch.comms.api.CommContext` (OpTree stage order: slow axes
last, carrying only the final 1/N shard), each rank updates its optimizer
shard, and parameters are re-gathered with the context all-gather.  Trees
are nested dicts (and lists) of tensors; the mesh comes from ``ctx`` or
the innermost ``comm_context``.
"""
from __future__ import annotations

from typing import Sequence

from ..comms import api
from ..tree import tree_map

__all__ = ["zero1_shard_grads", "zero1_unshard_params"]


def _mesh(ctx):
    c = ctx if ctx is not None else api.current_context()
    return c, api._require_mesh(c, "zero1")


def zero1_shard_grads(
    grads,
    fast_axes: Sequence[str],
    slow_axes: Sequence[str] = (),
    *,
    num_chunks: int = 1,
    ctx=None,
):
    """Reduce-scatter every gradient leaf over the data axes (ZeRO-1).

    Each DP rank ends with the leading-dim shard it owns for the optimizer
    update; slow (pod/DCN) axes are reduced on the already-scattered shard
    so they never carry the full gradient.  Leaves whose leading dim is not
    divisible by the DP size fall back to a full sum over every axis
    (replicated update).
    """
    c, mesh = _mesh(ctx)
    fast_axes = tuple(fast_axes)
    slow_axes = tuple(slow_axes)
    n = mesh.axis_size(fast_axes)

    def shard(g):
        if g.dim() and g.shape[0] % n == 0:
            y = api.reduce_scatter(g, axes=fast_axes, ctx=c,
                                   num_chunks=api.legacy_chunks(num_chunks))
            return mesh.psum(y, slow_axes) if slow_axes else y
        return mesh.psum(g, fast_axes + slow_axes)

    return tree_map(shard, grads)


def zero1_unshard_params(
    params,
    fast_axes: Sequence[str],
    *,
    reference=None,
    ctx=None,
):
    """Staged all-gather of updated parameter shards back to replicated.

    ``reference`` (the matching pre-scatter tree, e.g. the full params)
    tells which leaves ``zero1_shard_grads`` actually scattered: leaves
    that fell back to a replicated sum are returned unchanged.  Without a
    reference every leaf is gathered (the caller guarantees a uniform
    tree).
    """
    c, _ = _mesh(ctx)
    fast_axes = tuple(fast_axes)

    if reference is None:
        return tree_map(lambda p: api.all_gather(p, axes=fast_axes, ctx=c), params)

    def gather(p, full):
        if p.dim() and p.shape[0] != full.shape[0]:
            return api.all_gather(p, axes=fast_axes, ctx=c)
        return p

    return tree_map(gather, params, reference)
