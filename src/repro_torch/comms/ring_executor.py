"""Per-hop ring executor: ppermute-ring schedules for the staged engine.

The staged collectives issue one blocking collective per stage (Eq. 3's
``(d/B + a)·S`` with every stage a barrier).  This module is the execution
layer below that granularity: each stage runs as an explicit ring of
``ppermute`` hops, structured so the block received at hop t is *forwarded*
at hop t+1 while its local copy (all-gather) or local add (reduce-scatter)
is independent of the sends: the double-buffering that
``core.planner.perhop_stage_time`` models.  A hop is one
``batch_isend_irecv`` within the stage's axis group; each hop is waited on
before the next is posted, so the overlap the model prices is not yet
realized here (``async_op`` overlap is later speed work).

Every executor composes stage by stage exactly like the staged primitives in
``staged_collectives.py`` (stacking form + one local fix-up for AG; one
local block permutation for RS), so any planner stage order is supported and
the results are bit-identical to the one-shot collectives (reductions:
identical for exactly representable sums).  ``stage_modes`` lets the planner
pick the executor per stage: ``"ring"`` (per-hop ppermute) where the overlap
model wins, ``"oneshot"`` (the blocking collective) where a stage is too
small to pipeline (see ``core.planner.choose_hop_schedule``).

``fault_injection`` is the chaos hook of the fault layer: a
:class:`FaultInjection` replaces a chosen hop's *received* block (zeroed or
+1 everywhere) before it is stored or forwarded, so the verified executor
(``plan_executor.execute_plan_verified``) has something to catch.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .mesh_utils import FactorizedMesh, resolve_mesh
from .staged_allgather import _merge_device_axis
from .staged_collectives import (
    _a2a_merge_digits,
    _a2a_split_digits,
    _ag_finalize,
    _axis_sizes,
    _check_order,
    _interleave_chunks,
    _permute_blocks_to_order,
    _split_block_interior,
    _split_rs_chunks,
    _wavefront,
)

__all__ = [
    "FaultInjection",
    "fault_injection",
    "ring_all_gather_stage",
    "ring_reduce_scatter_stage",
    "ring_all_to_all_stage",
    "perhop_all_gather",
    "perhop_reduce_scatter",
    "perhop_all_reduce",
    "perhop_all_to_all",
    "hybrid_all_gather",
    "hybrid_reduce_scatter",
    "hybrid_all_reduce",
    "hybrid_all_to_all",
]


# --------------------------------------------------------------------------
# fault injection (chaos harness hook)
# --------------------------------------------------------------------------

@dataclass
class FaultInjection:
    """Corrupt a chosen ppermute hop of a ring stage, for chaos tests.

    ``axis`` is the mesh axis whose ring stage to hit, ``hop`` the 1-based
    hop index within the stage, ``mode`` either ``"drop"`` (the received
    block arrives zeroed: a lost lightpath) or ``"corrupt"`` (+1 to every
    element: a payload bit flip).  ``times`` bounds how many matching hop
    executions are corrupted: the verified executor's bounded retry runs
    the stage once per attempt, so ``times=1`` means only the first attempt
    sees the fault (the retry genuinely recovers) while a large ``times``
    keeps every attempt faulty (forcing the one-shot fallback).  ``device``
    optionally restricts the fault to the rank at that coordinate on
    ``axis``.

    ``applied`` counts the matching hop executions on this rank, the target
    or not: every rank runs the same hops, so every rank's count equals the
    reference's, where one trace serves all devices.
    """

    axis: str
    hop: int = 1
    mode: str = "drop"
    times: int = 1
    device: Optional[int] = None
    applied: int = 0  # mutable: matching hop executions consumed so far

    def __post_init__(self) -> None:
        if self.mode not in ("drop", "corrupt"):
            raise ValueError(f"mode must be drop|corrupt, got {self.mode!r}")


_INJECTIONS: List[FaultInjection] = []


@contextmanager
def fault_injection(spec: FaultInjection):
    """Activate ``spec`` for every ring stage run inside the block."""
    _INJECTIONS.append(spec)
    try:
        yield spec
    finally:
        _INJECTIONS.remove(spec)


def _maybe_inject(recv: torch.Tensor, name: str, hop: int,
                  mesh: FactorizedMesh) -> torch.Tensor:
    """Pass a just-received ppermute block through the active injections."""
    for spec in _INJECTIONS:
        if spec.axis != name or spec.hop != hop or spec.applied >= spec.times:
            continue
        spec.applied += 1
        if spec.device is not None and mesh.axis_index(name) != spec.device:
            continue
        recv = torch.zeros_like(recv) if spec.mode == "drop" else recv + 1
    return recv


def _origin_order(pieces, idx: int) -> torch.Tensor:
    """Arrival slot t holds origin (idx - t) mod m; flipping gives origin
    (idx + 1 + j) mod m at slot j, and rolling by idx+1 lands origin j at
    slot j: the all_gather stacking order, in one local copy."""
    stacked = torch.flip(torch.stack(pieces, dim=0), dims=(0,))
    return torch.roll(stacked, idx + 1, dims=0)


def ring_all_gather_stage(x: torch.Tensor, name: str, *,
                          mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """One ring all-gather stage in stacking form: equals
    ``lax.all_gather(x, name, axis=0, tiled=False)``.

    m-1 ppermute hops: the block received at hop t is forwarded at hop t+1
    while only being *referenced* locally (pieces are collected in arrival
    order, origin ``idx - t``).  One flip+roll at the end rotates arrival
    order into origin order.
    """
    mesh = resolve_mesh(mesh)
    m = mesh.axis_size(name)
    if m == 1:
        return x[None]
    idx = mesh.axis_index(name)
    nxt, prv = (idx + 1) % m, (idx - 1) % m
    pieces = [x]  # arrival order: origin idx, idx-1, ..., idx-(m-1)
    for t in range(1, m):
        pieces.append(_maybe_inject(mesh.ppermute(pieces[-1], name, nxt, prv),
                                    name, t, mesh))
    return _origin_order(pieces, idx)


def ring_reduce_scatter_stage(
    y: torch.Tensor, name: str, *, block_fn=None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """One ring reduce-scatter stage: equals ``lax.psum_scatter(y, name,
    scatter_dimension=0, tiled=True)`` up to reduction order (exact for
    exactly representable sums).

    The accumulator for block b travels the ring b+1 -> ... -> b, gaining
    one local contribution per hop.  ``block_fn(b)`` overrides the
    local-contribution provider (default: the b-th of m contiguous slices
    of ``y``); the collective-matmul fusion (ROADMAP A6) plugs in a
    just-in-time block matmul here.
    """
    mesh = resolve_mesh(mesh)
    m = mesh.axis_size(name)
    if m == 1:
        return y if block_fn is None else block_fn(0)
    if block_fn is None:
        if y.shape[0] % m:
            raise ValueError(
                f"length {y.shape[0]} not divisible by ring size {m}"
            )
        blk = y.shape[0] // m

        def block_fn(b):
            return y.narrow(0, b * blk, blk)

    idx = mesh.axis_index(name)
    nxt, prv = (idx + 1) % m, (idx - 1) % m
    acc = block_fn((idx - 1) % m)  # own contribution to the departing block
    for s in range(1, m):
        recv = _maybe_inject(mesh.ppermute(acc, name, nxt, prv), name, s, mesh)
        acc = recv + block_fn((idx - s - 1) % m)
    return acc


def ring_all_to_all_stage(y: torch.Tensor, name: str, *,
                          mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """One ring all-to-all digit transpose on the leading (m, ...) axis:
    equals ``lax.all_to_all(y, name, split_axis=0, concat_axis=0,
    tiled=True)`` bit for bit.

    m-1 ppermute hops, hop t carrying exactly the slices whose digit shift
    is t: rank q ships its resident slice (q+t) mod m along the rotation
    q -> (q+t) mod m, and receiver r files the arrival under origin
    (r-t) mod m.  There is no forwarding chain: every hop sends a distinct
    locally resident slice.  Arrival slot t holds origin (idx - t) mod m, so
    the same flip+roll as the all-gather ring restores origin order.
    """
    mesh = resolve_mesh(mesh)
    m = mesh.axis_size(name)
    if m == 1:
        return y
    if y.shape[0] != m:
        raise ValueError(f"digit axis {y.shape[0]} != ring size {m}")
    idx = mesh.axis_index(name)
    pieces = [y[idx]]
    for t in range(1, m):
        recv = mesh.ppermute(y[(idx + t) % m], name, (idx + t) % m, (idx - t) % m)
        pieces.append(_maybe_inject(recv, name, t, mesh))
    return _origin_order(pieces, idx)


def _resolve_modes(
    stage_modes: Optional[Sequence[str]], k: int
) -> Tuple[str, ...]:
    if stage_modes is None:
        return ("ring",) * k
    modes = tuple(stage_modes)
    if len(modes) != k or any(m not in ("ring", "oneshot") for m in modes):
        raise ValueError(
            f"stage_modes must be {k} of 'ring'|'oneshot', got {modes}"
        )
    return modes


def _ag_stage(ch, name, mode, mesh):
    if mode == "ring":
        return ring_all_gather_stage(ch, name, mesh=mesh)
    return mesh.all_gather(ch, name)


def _rs_stage(ch, name, mode, mesh):
    if mode == "ring":
        return ring_reduce_scatter_stage(ch, name, mesh=mesh)
    return mesh.psum_scatter(ch, name)


def _a2a_stage_dispatch(y, name, dim, mode, mesh):
    """One a2a digit transpose on digit axis ``dim``: a ppermute rotation
    ring ("ring") or the blocking collective ("oneshot")."""
    if mode == "ring":
        y = torch.movedim(y, dim, 0)
        y = ring_all_to_all_stage(y, name, mesh=mesh)
        return torch.movedim(y, 0, dim)
    return mesh.all_to_all(y, name, dim)


def perhop_all_gather(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    stage_modes: Optional[Sequence[str]] = None,
    stage_probe: Optional[Callable] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Per-hop staged all-gather of this rank's shard: bit-identical to
    ``lax.all_gather(x, tuple(axis_names), axis=axis, tiled=True)``.

    Stages run in ``stage_order`` (default major-first, the paper order),
    each as a ppermute ring (or the blocking collective where
    ``stage_modes`` says ``"oneshot"``); the stacked stage axes are
    collapsed to canonical order by one local transpose at the end.

    ``stage_probe(before, after, name)`` is called once per stage with the
    stage's input and output (the hook the verified executor of ROADMAP A10
    will use for per-stage checksums).
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else axis_names
    )
    modes = _resolve_modes(stage_modes, len(order))
    if axis < 0:
        axis += x.dim()
    y = x
    for name, mode in zip(order, modes):
        before = y
        y = _ag_stage(y, name, mode, mesh)
        if stage_probe is not None:
            stage_probe(before, y, name)
    y = _ag_finalize(y, axis_names, order)  # (N, *x.shape)
    return _merge_device_axis(y, axis)


def perhop_reduce_scatter(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    stage_modes: Optional[Sequence[str]] = None,
    stage_probe: Optional[Callable] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Per-hop staged reduce-scatter: equals ``lax.psum_scatter(x,
    tuple(axis_names), scatter_dimension=axis, tiled=True)`` (bit-identical
    for exactly representable sums; ring stages reduce in ring order).

    Default stage order is the paper-optimal reverse (slow axes last, on the
    smallest payload); any order composes via the same local pre-permutation
    ``staged_reduce_scatter`` uses.
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else tuple(reversed(axis_names))
    )
    modes = _resolve_modes(stage_modes, len(order))
    sizes = _axis_sizes(mesh, axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    n_total = mesh.axis_size(axis_names)
    if y.shape[0] % n_total:
        raise ValueError(
            f"axis length {y.shape[0]} not divisible by devices {n_total}"
        )
    if order != axis_names:
        y = _permute_blocks_to_order(y, axis_names, order, sizes)
    for name, mode in zip(order, modes):
        before = y
        y = _rs_stage(y, name, mode, mesh)
        if stage_probe is not None:
            stage_probe(before, y, name)
    return torch.movedim(y, 0, axis)


def perhop_all_to_all(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    stage_modes: Optional[Sequence[str]] = None,
    stage_probe: Optional[Callable] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Per-hop staged all-to-all of this rank's exchange buffer:
    bit-identical to ``lax.all_to_all(x, tuple(axis_names),
    split_axis=axis, concat_axis=axis, tiled=True)``.

    The N-block exchange factorizes into k per-sub-axis digit transposes
    that commute: any ``stage_order`` yields the identical output (no
    finalize transpose, unlike the gather family); only the modeled cost
    differs.  Each stage runs as a ppermute rotation ring or the blocking
    collective per ``stage_modes``.
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else axis_names
    )
    modes = _resolve_modes(stage_modes, len(order))
    sizes = _axis_sizes(mesh, axis_names)
    k = len(axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    shaped = _a2a_split_digits(y, axis_names, sizes)
    for name, mode in zip(order, modes):
        before = shaped
        shaped = _a2a_stage_dispatch(shaped, name, axis_names.index(name), mode, mesh)
        if stage_probe is not None:
            stage_probe(before, shaped, name)
    out = _a2a_merge_digits(shaped, k)
    return torch.movedim(out, 0, axis)


# --------------------------------------------------------------------------
# hybrid execution: the chunk wavefront OVER per-hop ring stages
# --------------------------------------------------------------------------
#
# ``staged_collectives`` pipelines C chunks over blocking whole-stage
# collectives; the executors below run the same wavefront with each stage
# dispatched per its planner stage mode (a "ring" stage is the ppermute
# ring, an "oneshot" stage the blocking collective).  This is the IR's
# ``hybrid`` plan mode (``core.planner.choose_hop_schedule`` emits it when
# its modeled makespan beats both pure modes); outputs stay bit-identical to
# the one-shot collectives exactly like the pure paths.

def hybrid_all_gather(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 2,
    stage_modes: Optional[Sequence[str]] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Chunk-wavefront per-hop staged all-gather: equals
    ``lax.all_gather(x, tuple(axis_names), axis=axis, tiled=True)`` bit for
    bit (same chunk interleave as ``staged_all_gather_chunked``, same ring
    stages as ``perhop_all_gather``)."""
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else axis_names
    )
    modes = _resolve_modes(stage_modes, len(order))
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    shard = y.shape[0]
    if shard % num_chunks:
        raise ValueError(f"shard length {shard} not divisible by {num_chunks}")
    per_chunk = shard // num_chunks
    chunks = [y[c * per_chunk:(c + 1) * per_chunk] for c in range(num_chunks)]
    chunks = _wavefront(
        chunks, len(order),
        lambda ch, j: _ag_stage(ch, order[j], modes[j], mesh),
    )
    gathered = [_ag_finalize(ch, axis_names, order) for ch in chunks]
    out = _interleave_chunks(gathered, gathered[0].shape[0] * shard)
    return torch.movedim(out, 0, axis)


def hybrid_reduce_scatter(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 2,
    stage_modes: Optional[Sequence[str]] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Chunk-wavefront per-hop staged reduce-scatter: equals
    ``lax.psum_scatter(x, tuple(axis_names), scatter_dimension=axis,
    tiled=True)`` (exact for exactly representable sums)."""
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else tuple(reversed(axis_names))
    )
    modes = _resolve_modes(stage_modes, len(order))
    sizes = _axis_sizes(mesh, axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    chunks = _split_rs_chunks(y, axis_names, order, sizes, num_chunks)
    chunks = _wavefront(
        chunks, len(order),
        lambda ch, j: _rs_stage(ch, order[j], modes[j], mesh),
    )
    out = chunks[0] if num_chunks == 1 else torch.cat(chunks, dim=0)
    return torch.movedim(out, 0, axis)


def hybrid_all_to_all(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    stage_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 2,
    stage_modes: Optional[Sequence[str]] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Chunk-wavefront per-hop staged all-to-all: equals
    ``lax.all_to_all(x, tuple(axis_names), split_axis=axis,
    concat_axis=axis, tiled=True)`` bit for bit (same block-interior chunk
    split as ``staged_all_to_all``, same digit-transpose stages as
    ``perhop_all_to_all``)."""
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(stage_order, axis_names)
        if stage_order is not None
        else axis_names
    )
    modes = _resolve_modes(stage_modes, len(order))
    sizes = _axis_sizes(mesh, axis_names)
    k = len(axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    shaped = _a2a_split_digits(y, axis_names, sizes)
    chunks = _split_block_interior(shaped, k, num_chunks)
    chunks = _wavefront(
        chunks, k,
        lambda ch, j: _a2a_stage_dispatch(
            ch, order[j], axis_names.index(order[j]), modes[j], mesh),
    )
    out = chunks[0] if num_chunks == 1 else torch.cat(chunks, dim=k)
    out = _a2a_merge_digits(out, k)
    return torch.movedim(out, 0, axis)


def hybrid_all_reduce(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    rs_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    num_chunks: int = 2,
    stage_modes: Optional[Sequence[str]] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Chunk-wavefront per-hop staged all-reduce (RS then AG over one plan,
    the 2k-stage chain pipelined across chunks): equals ``lax.psum(x,
    tuple(axis_names))`` up to ring-stage reduction order.  ``stage_modes``
    covers the full 2k-stage chain, matching
    ``choose_hop_schedule(..., collective="ar")``."""
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(rs_order, axis_names)
        if rs_order is not None
        else tuple(reversed(axis_names))
    )
    ag_order = tuple(reversed(order))
    k = len(axis_names)
    modes = _resolve_modes(stage_modes, 2 * k)
    sizes = _axis_sizes(mesh, axis_names)
    if axis < 0:
        axis += x.dim()
    y = torch.movedim(x, axis, 0)
    length = y.shape[0]
    chunks = _split_rs_chunks(y, axis_names, order, sizes, num_chunks)

    def apply_stage(ch, j):
        if j < k:
            return _rs_stage(ch, order[j], modes[j], mesh)
        return _ag_stage(ch, ag_order[j - k], modes[j], mesh)

    chunks = _wavefront(chunks, 2 * k, apply_stage)
    gathered = [_ag_finalize(ch, axis_names, ag_order) for ch in chunks]
    return torch.movedim(_interleave_chunks(gathered, length), 0, axis)


def perhop_all_reduce(
    x: torch.Tensor,
    axis_names: Sequence[str],
    *,
    rs_order: Optional[Sequence[str]] = None,
    axis: int = 0,
    stage_modes: Optional[Sequence[str]] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Per-hop staged all-reduce: RS then AG sharing one plan (the AG stage
    order is the reverse of the RS order).  Equals ``lax.psum(x,
    tuple(axis_names))`` up to reduction order.

    ``stage_modes`` covers the full 2k-stage chain (RS stages then AG
    stages), matching ``choose_hop_schedule(..., collective="ar")``.
    """
    mesh = resolve_mesh(mesh)
    axis_names = tuple(axis_names)
    order = (
        _check_order(rs_order, axis_names)
        if rs_order is not None
        else tuple(reversed(axis_names))
    )
    k = len(axis_names)
    modes = _resolve_modes(stage_modes, 2 * k)
    y = perhop_reduce_scatter(
        x, axis_names, stage_order=order, axis=axis, stage_modes=modes[:k],
        mesh=mesh,
    )
    return perhop_all_gather(
        y, axis_names, stage_order=tuple(reversed(order)), axis=axis,
        stage_modes=modes[k:], mesh=mesh,
    )
