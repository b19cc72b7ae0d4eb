"""Baseline collectives (paper §IV competitors) + hierarchical all-reduce.

Every primitive here takes this rank's local shard.  ``ring_all_gather``
and ``neighbor_exchange_all_gather`` are the paper's Ring and NE baselines
(ppermute wavefronts); ``one_stage_all_gather`` is the paper's one-stage
model, a single flat collective.  ``hierarchical_all_reduce`` is the
OpTree-style staged gradient sync: the slow (pod/DCN) axis only ever carries
the already-scattered shard, the direct analogue of OpTree stage 1 carrying
a single item per node.

Ring/NE unroll their step loops in Python: they are reference baselines for
correctness tests and small axes; the staged paths are the scale paths.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh_utils import FactorizedMesh, resolve_mesh
from .staged_allgather import _merge_device_axis, staged_all_gather
from .staged_collectives import staged_reduce_scatter

__all__ = [
    "ring_all_gather",
    "neighbor_exchange_all_gather",
    "one_stage_all_gather",
    "reduce_scatter",
    "hierarchical_all_reduce",
]


def one_stage_all_gather(x: torch.Tensor, axis_names, axis: int = 0, *,
                         mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """The paper's one-stage model: a single flat all-gather."""
    mesh = resolve_mesh(mesh)
    names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    if axis < 0:
        axis += x.dim()
    return _merge_device_axis(mesh.all_gather(x, names), axis)


def reduce_scatter(x: torch.Tensor, axis_name: str, axis: int = 0, *,
                   mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    mesh = resolve_mesh(mesh)
    if axis < 0:
        axis += x.dim()
    out = mesh.psum_scatter(torch.movedim(x, axis, 0), axis_name)
    return torch.movedim(out, 0, axis)


def ring_all_gather(x: torch.Tensor, axis_name: str, axis: int = 0, *,
                    mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """Classic N-1-step ring all-gather via ppermute (paper's Ring baseline)."""
    mesh = resolve_mesh(mesh)
    n = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    if axis < 0:
        axis += x.dim()
    x0 = torch.movedim(x, axis, 0)
    buf = x0.new_zeros((n,) + tuple(x0.shape))
    buf[idx] = x0
    cur = x0
    for t in range(1, n):
        cur = mesh.ppermute(cur, axis_name, (idx + 1) % n, (idx - 1) % n)
        buf[(idx - t) % n] = cur  # origin of the block arriving at step t
    out = buf.reshape((n * x0.shape[0],) + tuple(x0.shape[1:]))
    return torch.movedim(out, 0, axis)


def _ne_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pair-index bookkeeping for neighbor exchange.

    h[t, i] = index of the pair (block 2h, 2h+1) node i *received* at step t
    (h[0] = own pair after the first exchange).  partner[t, i] = neighbour
    exchanged with at step t.
    """
    steps = n // 2
    h = np.zeros((steps, n), dtype=np.int64)
    partner = np.zeros((steps, n), dtype=np.int64)
    h[0] = np.arange(n) // 2
    partner[0] = np.arange(n) ^ 1
    for t in range(1, steps):
        if t % 2 == 1:  # odd pairing: (1,2),(3,4),...,(n-1,0)
            p = np.where(np.arange(n) % 2 == 1, (np.arange(n) + 1) % n, (np.arange(n) - 1) % n)
        else:  # even pairing: (0,1),(2,3),...
            p = np.arange(n) ^ 1
        partner[t] = p
        h[t] = h[t - 1][p]
    return h, partner


def neighbor_exchange_all_gather(x: torch.Tensor, axis_name: str, axis: int = 0, *,
                                 mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """Neighbor-Exchange all-gather (Chen et al. 2005): N/2 exchange steps."""
    mesh = resolve_mesh(mesh)
    n = mesh.axis_size(axis_name)
    if n % 2:
        raise ValueError("neighbor exchange needs an even axis size")
    if n == 2:
        return one_stage_all_gather(x, axis_name, axis=axis, mesh=mesh)
    idx = mesh.axis_index(axis_name)
    h, partner = _ne_tables(n)
    if axis < 0:
        axis += x.dim()
    x0 = torch.movedim(x, axis, 0)
    buf = x0.new_zeros((n,) + tuple(x0.shape))
    buf[idx] = x0

    # step 0: swap own single block with the even-pairing partner
    p0 = int(partner[0, idx])
    buf[p0] = mesh.ppermute(x0, axis_name, p0, p0)

    # steps 1..n/2-1: forward the pair received last step (pair h[t-1])
    for t in range(1, n // 2):
        send_start = 2 * int(h[t - 1][idx])
        p = int(partner[t, idx])
        got = mesh.ppermute(buf[send_start:send_start + 2], axis_name, p, p)
        start = 2 * int(h[t][idx])
        buf[start:start + 2] = got

    out = buf.reshape((n * x0.shape[0],) + tuple(x0.shape[1:]))
    return torch.movedim(out, 0, axis)


def hierarchical_all_reduce(
    x: torch.Tensor,
    fast_axes: Sequence[str],
    slow_axes: Sequence[str] = (),
    *,
    gather: bool = True,
    num_chunks: int = 1,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """OpTree-staged all-reduce: reduce-scatter over the fast (ICI) axes,
    psum over the slow (pod/DCN) axes on the scattered shard, then staged
    all-gather back (slow axis never sees the full payload).

    With ``gather=False`` the result stays scattered over ``fast_axes``,
    the ZeRO-1 form.  The scatter runs in canonical (major-first) block
    order, so the scattered shard is exactly ``psum_scatter(x,
    fast_axes)``'s block for this rank.
    """
    mesh = resolve_mesh(mesh)
    fast_axes = tuple(fast_axes)
    slow_axes = tuple(slow_axes)
    y = staged_reduce_scatter(x, fast_axes, num_chunks=num_chunks, mesh=mesh)
    if slow_axes:
        y = mesh.psum(y, slow_axes)
    if gather:
        y = staged_all_gather(y, fast_axes, mesh=mesh)  # major-first (paper order)
    return y
