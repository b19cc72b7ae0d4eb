"""Staged (OpTree) all-gather over factorized mesh axes.

``staged_all_gather`` is the per-rank primitive: each rank passes its local
shard and runs the paper's k stages as a sequence of single-sub-axis
all-gathers.  Gathering minor-to-major needs no data movement beyond the
collectives themselves; any other stage order (e.g. the OpTree-optimal
"slow/major axis first while the payload is small") is followed by one
local transpose to restore the canonical order: layout work, not
communication.

``optree_all_gather`` plans the stage order from the cost model
(core.planner, Theorem 2) and runs it on the local shard.  The reference's
wrapper takes a globally sharded array and wraps ``shard_map``; in the
port a global array is a DTensor and takes ``comms.api``'s ops, so every op
here takes this rank's shard, the reference's "inside shard_map" contract.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..core.planner import DCN_LINK, ICI_LINK, LinkSpec, plan_axis_order
from .mesh_utils import FactorizedMesh, resolve_mesh

__all__ = ["staged_all_gather", "canonical_all_gather", "optree_all_gather",
           "link_for_axis", "names_for_plan"]


def link_for_axis(name: str, links: Optional[dict] = None) -> LinkSpec:
    """Link model for a mesh axis: explicit map wins, else 'pod*' names are
    DCN-class and everything else ICI."""
    if links and name in links:
        return links[name]
    return DCN_LINK if name.startswith("pod") else ICI_LINK


def names_for_plan(plan, axis_names, sizes, links=None):
    """Map a planned (size, link) stage sequence back to axis names (stable
    for duplicate (size, link) pairs)."""
    remaining = list(axis_names)
    order = []
    for st in plan.stages:
        for n in remaining:
            if sizes[n] == st.factor and link_for_axis(n, links).name == st.link.name:
                order.append(n)
                remaining.remove(n)
                break
    assert not remaining, (order, remaining)
    return tuple(order)


def _merge_device_axis(y: torch.Tensor, axis: int) -> torch.Tensor:
    """Fold a leading (N,) rank-block axis into local axis ``axis``: (N,
    *x.shape) -> x.shape with dim ``axis`` N times longer, the N blocks in
    order (the tiled layout)."""
    y = torch.movedim(y, 0, axis)
    shape = tuple(y.shape)
    return y.reshape(shape[:axis] + (shape[axis] * shape[axis + 1],) + shape[axis + 2:])


def staged_all_gather(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """k-stage all-gather of this rank's shard.

    Args:
      x: local shard.
      axis_names: the factorized sub-axes of the logical gather axis,
        *major first* (mesh order).  ``prod(sizes) = N``.
      stage_order: the order stages execute (default: paper order, major
        first, i.e. slowest/most-distant links carry the smallest payload).
      axis: array axis to gather along.
      mesh: the mesh (default: the active ``CommContext``'s).

    Returns the same value as ``jax.lax.all_gather(x, tuple(axis_names),
    axis=axis, tiled=True)``: blocks concatenated in canonical (major-first)
    order.
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = tuple(stage_order) if stage_order is not None else axis_names
    if sorted(order) != sorted(axis_names):
        raise ValueError(f"stage_order {order} must permute {axis_names}")
    if axis < 0:
        axis += x.dim()

    if order == tuple(reversed(axis_names)):
        # minor-to-major: tiled gathers compose to canonical order directly
        y = x
        for name in order:
            y = _merge_device_axis(mesh.all_gather(y, name), axis)
        return y

    # general order: stack stages as leading axes, then one local fix-up
    y = x
    for name in order:
        y = mesh.all_gather(y, name)
    # leading stacked axes are reversed(order); want axis_names order
    stacked = tuple(reversed(order))
    k = len(axis_names)
    perm = tuple(stacked.index(n) for n in axis_names) + tuple(range(k, y.dim()))
    y = y.permute(perm)
    gathered = math.prod(y.shape[:k])
    y = y.reshape((gathered,) + tuple(y.shape[k:]))  # (N, *x.shape)
    return _merge_device_axis(y, axis)


def canonical_all_gather(x: torch.Tensor, axis_names: Sequence[str], axis: int = 0,
                         *, mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """The flat single-shot all-gather over the product axis (baseline)."""
    mesh = resolve_mesh(mesh)
    if axis < 0:
        axis += x.dim()
    return _merge_device_axis(mesh.all_gather(x, tuple(axis_names)), axis)


def optree_all_gather(
    x: torch.Tensor,
    mesh: FactorizedMesh,
    axis_names: Sequence[str],
    *,
    links: Optional[dict] = None,
    axis: int = 0,
) -> torch.Tensor:
    """Staged all-gather whose stage order the planner picks (Theorem 2
    analogue), run on this rank's shard ``x``.

    Args:
      links: optional map axis_name -> LinkSpec (defaults: 'pod*' -> DCN,
        else ICI) for the planner.
    """
    axis_names = tuple(axis_names)
    sizes = {n: mesh.shape[n] for n in axis_names}
    shard_bytes = float(x.numel() * x.element_size())
    axes = [(sizes[n], link_for_axis(n, links)) for n in axis_names]
    plan = plan_axis_order(axes, shard_bytes)
    order = names_for_plan(plan, axis_names, sizes, links)
    return staged_all_gather(x, axis_names, stage_order=order, axis=axis, mesh=mesh)
