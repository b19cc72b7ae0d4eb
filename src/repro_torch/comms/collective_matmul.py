"""Collective-matmul fusion: a gather-adjacent matmul run hop by hop.

Ring code over ``torch.distributed``, not a CUDA kernel: the reference's
``kernels/collective_matmul.py`` holds no ``pl.pallas_call`` either (its
rings are ``ppermute`` hops and its block products ``einsum``).  The block
products here are ``torch.einsum``, the hops ``FactorizedMesh.ppermute``.
Every op takes this rank's local shard, as inside the reference's
``shard_map``.

The two shapes that dominate explicit-TP transformer blocks, run when
``api.allgather_matmul`` / ``api.matmul_reduce_scatter`` decide to fuse,
with the stage order of the context's plan:

  * **all-gather -> matmul** (sequence-parallel FFN entry / QKV):
    ``fused_allgather_matmul`` runs every stage of the gather as a ring and
    multiplies each block the hop it lands.
  * **matmul -> reduce-scatter** (TP combine back to sequence shards):
    ``fused_matmul_reduce_scatter`` computes the block feeding ring hop t
    *just-in-time*, through ``ring_reduce_scatter_stage(block_fn=...)``;
    later stages are plain reduce-scatter rings.

Both equal the unfused ``collective o matmul`` composition: each output
block is the same block matmul, so AG-side results are bit-comparable; the
RS ring reduces in ring order, so it is exact for exactly representable
sums.  Each hop is one blocking ``batch_isend_irecv``, so the overlap the
planner's fusion model prices is not realized yet (``async_op`` hops are
later speed work); the values and the collectives issued are the
reference's.

**Backward pass** (``torch.autograd.Function``): the two shapes are each
other's duals, so the backward collectives reuse the fused rings:

  * all-gather -> matmul: dx = matmul -> reduce-scatter(cat(dout), cat(w)^T)
    over the reversed stage order, plus the gathered activations' own
    cotangent reduce-scattered; dw = gathered^T @ dout is local (the
    gathered activations are saved, so nothing is gathered again).
  * matmul -> reduce-scatter: (AG(dy), dh) come from ONE fused
    all-gather -> matmul ring over ``w^T`` over the reversed stage order;
    dw = h^T @ AG(dy).

Every rank issues the same collectives in the same order in the backward.
The mesh is carried explicitly into the backward: autograd may run it on a
thread of its own, where no ``comm_context`` is installed.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from .mesh_utils import FactorizedMesh
from .ring_executor import _origin_order, ring_reduce_scatter_stage
from .staged_allgather import _merge_device_axis
from .staged_collectives import (
    _ag_finalize,
    _axis_sizes,
    _check_order,
    _permute_blocks_to_order,
)

__all__ = ["fused_allgather_matmul", "fused_matmul_reduce_scatter"]


def _mm(piece: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the trailing feature dim of ``piece`` (any leading/stacked
    dims) with weight ``w`` (d_in, d_out)."""
    return torch.einsum("...d,df->...f", piece, w)


def _fused_ring_ag_stage(
    cur: torch.Tensor, outs: List[torch.Tensor], name: str,
    ws: Sequence[torch.Tensor], mesh: FactorizedMesh,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One ring all-gather stage that also multiplies every arriving payload.

    ``cur`` is the gathered-so-far data (stacked stage axes leading); ``outs``
    mirror it with the feature dim already projected through each weight.
    Returns the stacked (m, ...) data and outputs, the layout of
    ``lax.all_gather(axis=0, tiled=False)``, so the standard finalize
    transpose applies to both.  The block received at hop t is forwarded at
    hop t+1 and multiplied after that send.
    """
    m = mesh.axis_size(name)
    if m == 1:
        return cur[None], [o[None] for o in outs]
    idx = mesh.axis_index(name)
    nxt, prv = (idx + 1) % m, (idx - 1) % m
    pieces = [cur]  # arrival order: origin idx, idx-1, ..., idx-(m-1)
    opieces = [[o] for o in outs]
    for t in range(1, m):
        pieces.append(mesh.ppermute(pieces[-1], name, nxt, prv))  # hop t ...
        if t > 1:
            # ... then the previous delivery is multiplied
            for op, w in zip(opieces, ws):
                op.append(_mm(pieces[t - 1], w))
    for op, w in zip(opieces, ws):
        op.append(_mm(pieces[m - 1], w))
    return (_origin_order(pieces, idx),
            [_origin_order(op, idx) for op in opieces])


def _allgather_matmul_impl(
    x: torch.Tensor,
    ws: Sequence[torch.Tensor],
    axis_names: Tuple[str, ...],
    order: Tuple[str, ...],
    axis: int,
    mesh: FactorizedMesh,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    cur = x
    outs = [_mm(x, w) for w in ws]  # the local block
    for name in order:
        cur, outs = _fused_ring_ag_stage(cur, outs, name, ws, mesh)

    gathered = _merge_device_axis(_ag_finalize(cur, axis_names, order), axis)
    outs = tuple(_merge_device_axis(_ag_finalize(o, axis_names, order), axis)
                 for o in outs)
    return gathered, outs


def _matmul_reduce_scatter_impl(
    h: torch.Tensor,
    w: torch.Tensor,
    axis_names: Tuple[str, ...],
    order: Tuple[str, ...],
    axis: int,
    mesh: FactorizedMesh,
) -> torch.Tensor:
    sizes = _axis_sizes(mesh, axis_names)
    n_total = math.prod(sizes.values())
    h0 = torch.movedim(h, axis, 0) if axis != 0 else h
    if h0.shape[0] % n_total:
        raise ValueError(
            f"scatter axis length {h0.shape[0]} not divisible by {n_total}")
    # the scatter permutes whole rows, and the matmul is row-wise, so the
    # canonical -> stage-order block permutation commutes with it and is
    # applied to the *input* (no full-size output ever materializes)
    if order != axis_names:
        h0 = _permute_blocks_to_order(h0, axis_names, order, sizes)

    blk = h0.shape[0] // sizes[order[0]]

    def part(b):
        return _mm(h0.narrow(0, b * blk, blk), w)  # just-in-time block matmul

    y = ring_reduce_scatter_stage(h0, order[0], block_fn=part, mesh=mesh)
    for name in order[1:]:
        y = ring_reduce_scatter_stage(y, name, mesh=mesh)
    return torch.movedim(y, 0, axis) if axis != 0 else y


def _rev(seq: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(reversed(seq))


def _psum_scatter_axis(y: torch.Tensor, names, axis: int,
                       mesh: FactorizedMesh) -> torch.Tensor:
    """``lax.psum_scatter(y, names, scatter_dimension=axis, tiled=True)``."""
    return torch.movedim(mesh.psum_scatter(torch.movedim(y, axis, 0), names), 0, axis)


class _AllgatherMatmul(torch.autograd.Function):
    """The reference's ``_ag_matmul_vjp``: forward the fused ring, backward
    its dual (a matmul -> reduce-scatter ring over the reversed order)."""

    @staticmethod
    def forward(fctx, spec, x, *ws):
        axis_names, order, axis, mesh = spec
        gathered, outs = _allgather_matmul_impl(x, ws, axis_names, order, axis, mesh)
        fctx.spec = spec
        # the gathered activations double as the dw contraction input (no
        # re-gather in the backward pass)
        fctx.save_for_backward(gathered, *ws)
        return (gathered,) + outs

    @staticmethod
    def backward(fctx, d_gathered, *d_outs):
        axis_names, order, axis, mesh = fctx.spec
        gathered, *ws = fctx.saved_tensors
        # dgrad reuses the fused ring as its DUAL; several weights share one
        # ring via a feature concat
        douts_cat = torch.cat(d_outs, dim=-1) if len(d_outs) > 1 else d_outs[0]
        w_cat = torch.cat(ws, dim=-1) if len(ws) > 1 else ws[0]
        dx = _matmul_reduce_scatter_impl(
            douts_cat, w_cat.transpose(0, 1), axis_names, _rev(order), axis, mesh)
        # the gathered-activation output's own cotangent: AG's transpose
        dx = dx + _psum_scatter_axis(d_gathered, axis_names, axis, mesh)
        dws = tuple(torch.einsum("...d,...f->df", gathered, do) for do in d_outs)
        return (None, dx) + dws


class _MatmulReduceScatter(torch.autograd.Function):
    """The reference's ``_mm_rs_vjp``: backward is ONE fused
    ``allgather_matmul`` ring over ``w^T`` (the RS dual)."""

    @staticmethod
    def forward(fctx, spec, h, w):
        axis_names, order, axis, mesh = spec
        fctx.spec = spec
        fctx.save_for_backward(h, w)
        return _matmul_reduce_scatter_impl(h, w, axis_names, order, axis, mesh)

    @staticmethod
    def backward(fctx, dy):
        axis_names, order, axis, mesh = fctx.spec
        h, w = fctx.saved_tensors
        g_dy, (dh,) = _allgather_matmul_impl(
            dy, (w.transpose(0, 1),), axis_names, _rev(order), axis, mesh)
        dw = torch.einsum("...k,...f->kf", h, g_dy)
        return None, dh, dw


def fused_allgather_matmul(
    x: torch.Tensor,
    ws: Sequence[torch.Tensor],
    axis_names: Sequence[str],
    stage_order: Sequence[str],
    axis: int,
    mesh: FactorizedMesh,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``all_gather(x, axis_names, axis=axis, tiled=True) @ w`` for each
    ``w`` in ``ws`` (one gather shared by all of them), with every gathered
    block multiplied the hop it lands; ``x`` is this rank's shard and
    ``axis`` non-negative.  Returns ``(gathered_x, outs)``.
    Differentiable: dgrad runs as the fused matmul -> reduce-scatter dual
    over the reversed stage order."""
    axis_names = tuple(axis_names)
    spec = (axis_names, _check_order(stage_order, axis_names), axis, mesh)
    gathered, *outs = _AllgatherMatmul.apply(spec, x, *ws)
    return gathered, tuple(outs)


def fused_matmul_reduce_scatter(
    h: torch.Tensor,
    w: torch.Tensor,
    axis_names: Sequence[str],
    stage_order: Sequence[str],
    axis: int,
    mesh: FactorizedMesh,
) -> torch.Tensor:
    """``psum_scatter(h @ w, axis_names, scatter_dimension=axis, tiled=True)``
    with the matmul decomposed per scattered block (this rank's full-length
    ``h`` and row slice ``w``; ``axis`` non-negative).  Values equal the
    unfused composition up to the ring's reduction order.  Differentiable:
    the backward pass is one fused all-gather -> matmul ring producing dgrad
    and the gathered cotangent."""
    axis_names = tuple(axis_names)
    spec = (axis_names, _check_order(stage_order, axis_names), axis, mesh)
    return _MatmulReduceScatter.apply(spec, h, w)
