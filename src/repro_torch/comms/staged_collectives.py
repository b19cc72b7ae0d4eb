"""Staged collective engine: OpTree's k-stage machinery generalized beyond
all-gather.

``staged_all_gather`` (staged_allgather.py) runs the paper's stages
minor-payload-first so the slow links move the *small* payload.  This module
adds the rest of the gather-shaped family:

  * ``staged_reduce_scatter``: the exact dual.  A reduce-scatter's payload
    *shrinks* stage by stage, so the paper-optimal order is the **reverse**
    of the all-gather order: the slow (pod/DCN) axes run last, when each
    rank holds only the final 1/N shard.  Any stage order composes to the
    canonical (major-first) block layout after one *local* block permutation
    before the scatters: layout work, not communication (the mirror of the
    all-gather's post-transpose).
  * ``staged_all_reduce``: reduce-scatter + all-gather sharing one plan
    (the AG stage order is the reverse of the RS order).
  * **chunked execution**: every primitive takes ``num_chunks=C``: the
    shard is split into C chunks and stage j of chunk i is issued in the
    same wavefront as stage j+1 of chunk i-1 (SWOT-style software
    pipelining).  The planner (``core.planner.choose_num_chunks``) decides
    C from the alpha/bandwidth trade-off.  Here each stage is a blocking
    ``torch.distributed`` collective, issued in the wavefront's order;
    overlapping them (``async_op=True``) is left to later speed work.

Every function takes this rank's local array (the reference's "inside
shard_map" contract) and the mesh (default: the active ``CommContext``'s).
The user-facing surface is the context-scoped API
(``repro_torch.comms.api``: ``comm_context`` + module ops);
``StagedCollectiveEngine`` and ``tp_all_reduce`` remain as deprecation shims
routing through it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.plan_ir import CollectivePlan
from ..core.planner import (
    LinkSpec,
    choose_hop_schedule,
    plan_axis_order,
    plan_reduce_scatter_order,
)
from .mesh_utils import FactorizedMesh, resolve_mesh
from .staged_allgather import link_for_axis, names_for_plan, staged_all_gather

__all__ = [
    "staged_reduce_scatter",
    "staged_all_reduce",
    "staged_all_gather_chunked",
    "staged_all_to_all",
    "tp_all_reduce",
    "fit_chunks",
    "plan_collectives",
    "StagedCollectiveEngine",
]


# --------------------------------------------------------------------------
# per-rank primitives
# --------------------------------------------------------------------------

def _check_order(order, axis_names) -> Tuple[str, ...]:
    order = tuple(order)
    if sorted(order) != sorted(axis_names):
        raise ValueError(f"stage_order {order} must permute {axis_names}")
    return order


def _axis_sizes(mesh: FactorizedMesh, axis_names: Sequence[str]) -> Dict[str, int]:
    return {n: mesh.shape[n] for n in axis_names}


def _permute_blocks_to_order(y, axis_names, order, sizes):
    """Local permutation of the N rank blocks along dim 0 from canonical
    (major-first ``axis_names``) layout to ``order`` layout, so tiled
    reduce-scatter stages executed in ``order`` land each rank on its
    canonical block.  Pure layout work: no communication."""
    k = len(axis_names)
    n_total = math.prod(sizes[n] for n in axis_names)
    block = y.shape[0] // n_total
    shaped = y.reshape(tuple(sizes[n] for n in axis_names) + (block,) + tuple(y.shape[1:]))
    perm = tuple(axis_names.index(n) for n in order)
    shaped = shaped.permute(perm + tuple(range(k, shaped.dim())))
    return shaped.reshape(y.shape)


def _ag_finalize(y, axis_names, order):
    """Collapse the k stacked stage axes (reversed(order) leading) into one
    canonical (N, ...) rank axis."""
    k = len(axis_names)
    stacked = tuple(reversed(order))
    perm = tuple(stacked.index(n) for n in axis_names)
    y = y.permute(perm + tuple(range(k, y.dim())))
    n_total = math.prod(y.shape[:k])
    return y.reshape((n_total,) + tuple(y.shape[k:]))


def _wavefront(chunks: List, num_stages: int, apply_stage) -> List:
    """Software pipeline: at tick t, chunk c runs stage t-c, so stage j of
    chunk i is issued alongside stage j+1 of chunk i-1."""
    num_chunks = len(chunks)
    for t in range(num_chunks + num_stages - 1):
        for c in range(num_chunks):
            j = t - c
            if 0 <= j < num_stages:
                chunks[c] = apply_stage(chunks[c], j)
    return chunks


def _split_rs_chunks(y, axis_names, order, sizes, num_chunks):
    """Split the (movedim'd) input into num_chunks RS-ready chunks: chunk c
    holds every rank block's c-th slice, pre-permuted to ``order`` layout
    when the stage order is non-canonical.  Raises on indivisibility."""
    n_total = math.prod(sizes.values())
    length = y.shape[0]
    if length % (n_total * num_chunks):
        raise ValueError(
            f"axis length {length} not divisible by devices*chunks "
            f"{n_total}*{num_chunks}"
        )

    def prep(chunk):
        if order != axis_names:
            return _permute_blocks_to_order(chunk, axis_names, order, sizes)
        return chunk

    if num_chunks == 1:
        return [prep(y)]
    per_chunk = length // n_total // num_chunks
    rest = tuple(y.shape[1:])
    blocks = y.reshape((n_total, num_chunks, per_chunk) + rest)
    return [
        prep(blocks[:, c].reshape((n_total * per_chunk,) + rest))
        for c in range(num_chunks)
    ]


def _interleave_chunks(gathered: List[torch.Tensor], length: int) -> torch.Tensor:
    """Each chunk's canonical (N, per_chunk, ...) gather -> one (length,
    ...) array in which rank p's shard is the concat of its chunks."""
    out = torch.stack(gathered, dim=1)  # (N, C, per_chunk, ...)
    return out.reshape((length,) + tuple(out.shape[3:]))


def staged_reduce_scatter(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 1,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """k-stage reduce-scatter of this rank's addend, the dual of
    ``staged_all_gather``.

    Returns the same value as ``jax.lax.psum_scatter(x, tuple(axis_names),
    scatter_dimension=axis, tiled=True)``: rank p (canonical major-first
    order) ends with block p of the sum.

    Args:
      axis_names: factorized sub-axes of the logical axis, *major first*.
      stage_order: execution order (default: paper order, major/slow axis
        **last**, i.e. the slow links carry the smallest payload).
      num_chunks: split the output shard into C chunks and pipeline the
        stages across chunks.
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else tuple(reversed(axis_names))
    )
    sizes = _axis_sizes(mesh, axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    chunks = _split_rs_chunks(y, axis_names, order, sizes, num_chunks)
    chunks = _wavefront(
        chunks, len(order), lambda ch, j: mesh.psum_scatter(ch, order[j])
    )
    out = chunks[0] if num_chunks == 1 else torch.cat(chunks, dim=0)
    return torch.movedim(out, 0, axis)


def staged_all_gather_chunked(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 2,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Chunked/pipelined ``staged_all_gather``: equals
    ``lax.all_gather(x, tuple(axis_names), axis=axis, tiled=True)``."""
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else axis_names
    )
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    shard = y.shape[0]
    if shard % num_chunks:
        raise ValueError(f"shard length {shard} not divisible by {num_chunks}")
    per_chunk = shard // num_chunks
    chunks = [y[c * per_chunk:(c + 1) * per_chunk] for c in range(num_chunks)]
    chunks = _wavefront(
        chunks, len(order), lambda ch, j: mesh.all_gather(ch, order[j])
    )
    gathered = [_ag_finalize(ch, axis_names, order) for ch in chunks]
    out = _interleave_chunks(gathered, gathered[0].shape[0] * shard)
    return torch.movedim(out, 0, axis)


def _a2a_split_digits(y, axis_names, sizes):
    """(n_total·B, ...) -> (s_1, ..., s_k, B, ...): expose the N destination
    blocks of an all-to-all buffer as one mixed-radix digit axis per sub-axis
    (canonical major-first order), so each stage can transpose its own
    digit independently."""
    n_total = math.prod(sizes[n] for n in axis_names)
    if y.shape[0] % n_total:
        raise ValueError(
            f"axis length {y.shape[0]} not divisible by devices {n_total}"
        )
    block = y.shape[0] // n_total
    return y.reshape(
        tuple(sizes[n] for n in axis_names) + (block,) + tuple(y.shape[1:])
    )


def _a2a_merge_digits(y, k: int):
    """Inverse of ``_a2a_split_digits``: collapse the k digit axes + block
    interior back into one (n_total·B, ...) leading axis."""
    n_total = math.prod(y.shape[:k])
    return y.reshape((n_total * y.shape[k],) + tuple(y.shape[k + 1:]))


def _split_block_interior(shaped, k: int, num_chunks: int) -> List[torch.Tensor]:
    block = shaped.shape[k]
    if block % num_chunks:
        raise ValueError(
            f"block interior {block} not divisible by {num_chunks} chunks"
        )
    per = block // num_chunks
    return [shaped.narrow(k, c * per, per) for c in range(num_chunks)]


def staged_all_to_all(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 1,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """k-stage all-to-all of this rank's exchange buffer: equals
    ``lax.all_to_all(x, tuple(axis_names), split_axis=axis,
    concat_axis=axis, tiled=True)`` bit for bit.

    The N-block exchange factorizes into k per-sub-axis digit transposes
    that COMMUTE: any ``stage_order`` yields the identical output and only
    the modeled cost differs.  ``num_chunks=C`` splits the block *interior*
    into C slices and pipelines the stage chain across them in the same
    wavefront as the gather family.
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else axis_names
    )
    sizes = _axis_sizes(mesh, axis_names)
    k = len(axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    shaped = _a2a_split_digits(y, axis_names, sizes)
    chunks = _split_block_interior(shaped, k, num_chunks)
    chunks = _wavefront(
        chunks, k,
        lambda ch, j: mesh.all_to_all(ch, order[j], axis_names.index(order[j])),
    )
    out = chunks[0] if num_chunks == 1 else torch.cat(chunks, dim=k)
    out = _a2a_merge_digits(out, k)
    return torch.movedim(out, 0, axis)


def staged_all_reduce(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    rs_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 1,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Staged all-reduce = staged RS + staged AG sharing one plan.

    Equals ``jax.lax.psum(x, tuple(axis_names))``.  The AG stage order is
    the reverse of the RS order, so each payload size crosses each link
    class exactly twice and the slow links only ever carry the scattered
    (smallest) payloads.  With ``num_chunks=C`` the whole 2k-stage RS+AG
    chain is software-pipelined across chunks.
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(rs_order, axis_names)
        if rs_order is not None
        else tuple(reversed(axis_names))
    )
    ag_order = tuple(reversed(order))
    sizes = _axis_sizes(mesh, axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    length = y.shape[0]

    if num_chunks == 1:
        out = staged_reduce_scatter(y, axis_names, stage_order=order, mesh=mesh)
        out = staged_all_gather(out, axis_names, stage_order=ag_order, mesh=mesh)
        return torch.movedim(out, 0, axis)

    k = len(axis_names)
    chunks = _split_rs_chunks(y, axis_names, order, sizes, num_chunks)

    def apply_stage(ch, j):
        if j < k:
            return mesh.psum_scatter(ch, order[j])
        return mesh.all_gather(ch, ag_order[j - k])

    chunks = _wavefront(chunks, 2 * k, apply_stage)
    gathered = [_ag_finalize(ch, axis_names, ag_order) for ch in chunks]
    return torch.movedim(_interleave_chunks(gathered, length), 0, axis)


def tp_all_reduce(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    axis: int = -1,
    num_chunks: int = 1,
) -> torch.Tensor:
    """DEPRECATED shim: tensor-parallel partial-sum combine.

    Use :func:`repro_torch.comms.api.all_reduce` (context-scoped,
    plan-cached) instead; this shim routes through it with the same contract
    (staged AR when divisible, flat all-reduce otherwise)."""
    import warnings

    from . import api

    warnings.warn(
        "tp_all_reduce is deprecated; use repro_torch.comms.api.all_reduce "
        "under a comm_context", DeprecationWarning, stacklevel=2)
    return api.all_reduce(
        x, axis=axis, axes=tuple(axis_names),
        num_chunks=api.legacy_chunks(num_chunks))


# --------------------------------------------------------------------------
# planning + user-facing engine
# --------------------------------------------------------------------------

def plan_collectives(
    mesh,
    axis_names: Sequence[str],
    shard_bytes: float,
    *,
    links: Optional[Dict[str, LinkSpec]] = None,
    max_chunks: int = 8,
) -> Dict[str, CollectivePlan]:
    """One :class:`~repro_torch.core.plan_ir.CollectivePlan` per collective
    ("ag" / "rs" / "ar" / "a2a") for this (mesh axes, payload) point.

    ``mesh`` is a :class:`FactorizedMesh` or a plain ``{axis: size}`` dict
    (the comms context plans meshless from its axis sizes).  Stage orders
    come from the cost-model planners (slow axis first for AG, last for RS;
    the AR chain is the RS order followed by its reverse), the execution
    mode + per-stage hop structure + chunk count from
    ``core.planner.choose_hop_schedule``, all carried ON the plan, so the
    executor (``comms.plan_executor.execute_plan``), the pricer
    (``core.cost_model.price``) and the optical validator
    (``core.schedule.schedule_from_ir`` -> ``optics.simulator``) consume the
    same object.  ``shard_bytes`` is the per-rank payload at the scattered
    end (AG input / RS output); for "a2a" it is the rank's full local
    exchange buffer (all N destination blocks), matching the IR's
    scaled-payload law (stage j moves shard/f_j)."""
    axis_names = tuple(axis_names)
    if isinstance(mesh, dict):
        sizes = {n: int(mesh[n]) for n in axis_names}
    else:
        sizes = {n: mesh.shape[n] for n in axis_names}
    axes = [(sizes[n], link_for_axis(n, links)) for n in axis_names]
    ag_plan = plan_axis_order(axes, shard_bytes, max_chunks=max_chunks)
    rs_plan = plan_reduce_scatter_order(axes, shard_bytes, max_chunks=max_chunks)
    ag_order = names_for_plan(ag_plan, axis_names, sizes, links)
    rs_order = names_for_plan(rs_plan, axis_names, sizes, links)
    ag_links = [s.link for s in ag_plan.stages]
    rs_links = [s.link for s in rs_plan.stages]
    scheds = {
        "ag": (choose_hop_schedule(
            ag_plan.factors, ag_links, shard_bytes,
            max_chunks=max_chunks, collective="ag"), ag_order),
        "rs": (choose_hop_schedule(
            rs_plan.factors, rs_links, shard_bytes,
            max_chunks=max_chunks, collective="rs"), rs_order),
        "ar": (choose_hop_schedule(
            rs_plan.factors, rs_links, shard_bytes,
            max_chunks=max_chunks, collective="ar"),
            rs_order + tuple(reversed(rs_order))),
        # electrical a2a cost is stage-order invariant (each stage moves
        # shard·(f-1)/f regardless of position), so reuse the AG order as
        # the deterministic choice; order-sensitive optical planning goes
        # through search_stage_orders / PlanPolicy(order="search") instead
        "a2a": (choose_hop_schedule(
            ag_plan.factors, ag_links, shard_bytes,
            max_chunks=max_chunks, collective="a2a"), ag_order),
    }
    plans: Dict[str, CollectivePlan] = {}
    for coll, (sched, order) in scheds.items():
        plan = sched.to_ir(order)
        plans[coll] = dataclasses.replace(
            plan, meta={**plan.meta, "axis_names": axis_names})
    return plans


def fit_chunks(length: int, granularity: int, chunks: int) -> int:
    """Largest power-of-two <= chunks such that length divides into
    granularity*chunks pieces (planner chunk counts are powers of two)."""
    while chunks > 1 and length % (granularity * chunks):
        chunks //= 2
    return chunks


class StagedCollectiveEngine:
    """DEPRECATED shim over the context-scoped API (``repro_torch.comms.api``).

    Each method delegates to the module-level ops with an explicit ``ctx=``
    handle, so legacy call sites share the same plan cache, policy machinery
    and links auto-invalidation as the new surface:

        eng = StagedCollectiveEngine(mesh, ("pod", "data"))
        y = eng.all_reduce(x)          # == api.all_reduce(x, ctx=eng.ctx)

    Every method takes this rank's local array.  New code should use
    ``comm_context(mesh, axis_names)`` + the ``repro_torch.comms.api`` ops
    directly.
    """

    def __init__(
        self,
        mesh: FactorizedMesh,
        axis_names: Sequence[str],
        *,
        links: Optional[Dict[str, LinkSpec]] = None,
        max_chunks: int = 8,
    ):
        import warnings

        from .api import CommContext, PlanPolicy

        warnings.warn(
            "StagedCollectiveEngine is deprecated; use "
            "repro_torch.comms.api.comm_context(mesh, axis_names) and the "
            "module-level ops", DeprecationWarning, stacklevel=2)
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.max_chunks = max_chunks
        self.n_devices = math.prod(mesh.shape[n] for n in self.axis_names)
        self.ctx = CommContext(
            mesh, self.axis_names, links=links,
            policy=PlanPolicy(max_chunks=max_chunks),
        )

    @property
    def links(self):
        return self.ctx.links

    def plan(self, x: torch.Tensor, collective: str = "ag") -> CollectivePlan:
        """The CollectivePlan the context would execute for this rank's
        ``x``: the shard for AG, the full-length addend or buffer for RS, AR
        and a2a (the scattered-end payload is then nbytes/N, as
        ``api._local_plan`` computes it)."""
        nbytes = x.numel() * x.element_size()
        shard_bytes = nbytes if collective in ("ag", "a2a") else nbytes / self.n_devices
        return self.ctx.plan(collective, shard_bytes,
                             shape=tuple(x.shape), dtype=x.dtype)

    def all_gather(self, x: torch.Tensor, *, axis: int = 0,
                   mode: Optional[str] = None) -> torch.Tensor:
        """This rank's shard -> the full gather."""
        from . import api

        return api.all_gather(x, axis=axis, ctx=self.ctx, mode=mode)

    def reduce_scatter(self, x: torch.Tensor, *, axis: int = 0,
                       mode: Optional[str] = None) -> torch.Tensor:
        """This rank's full-length addend -> its block of the sum."""
        from . import api

        return api.reduce_scatter(x, axis=axis, ctx=self.ctx, mode=mode)

    def all_reduce(self, x: torch.Tensor, *, axis: int = 0,
                   mode: Optional[str] = None) -> torch.Tensor:
        """This rank's addend -> the sum over ``axis_names``."""
        from . import api

        return api.all_reduce(x, axis=axis, ctx=self.ctx, mode=mode)
