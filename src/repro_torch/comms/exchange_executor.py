"""Pairwise-exchange executor: recursive-doubling rounds for latency plans.

The planner's latency regime (``core.planner.plan_latency_collective``)
emits plans whose every stage is a factor-2 bidirectional pairwise exchange
(``PlanStage.mode == "exchange"``): log2(n)-ish round chains instead of the
m-ary ring chains the bandwidth regime uses.  This module executes those
rounds as paired ``ppermute``s (one ``batch_isend_irecv`` between the two
ranks of a pair inside the axis group): each round, every rank swaps its
whole buffer (gather) or half its buffer (scatter) with the partner whose
index differs in one bit of one mesh-axis coordinate.

Digit bookkeeping: a plan's rounds are grouped per axis (the planner emits
each axis's rounds contiguously).  A gather group over an axis of size
``2^k`` runs k rounds MSB-first (round t pairs across bit ``k-1-t``), each
stacking the received buffer as a new LEADING digit axis, so the final digit
order is the reverse of round order; one closing transpose + reshape lands
the blocks in the canonical major-first ``meta["axis_names"]`` layout, the
same output convention as ``ring_executor``/``staged_collectives``, so the
results are bit-identical to the one-shot collectives (AG exactly; RS and
AR for exactly representable sums).  A scatter group is the time-mirror:
the input is pre-transposed from canonical digit order into round order,
then each round keeps the half matching this rank's bit and sends the other
half to the partner, adding what arrives.

``stage_probe(before, after, name)`` fires once per AXIS GROUP (not per
round) with the group's entry/exit buffers: group-level conservation over
the full named axis, the same checksum granularity
``plan_executor.execute_plan_verified`` uses on the ring paths.  Chaos
injection (``ring_executor.fault_injection``) applies per round, with hops
numbered 1..k within each group.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.plan_ir import CollectivePlan, PlanStage
from .mesh_utils import FactorizedMesh, resolve_mesh
from .ring_executor import _maybe_inject

__all__ = [
    "exchange_all_gather",
    "exchange_reduce_scatter",
    "exchange_all_reduce",
]


def _canonical_names(plan: CollectivePlan) -> Tuple[str, ...]:
    names = plan.meta.get("axis_names")
    if not names:
        raise ValueError(
            "exchange plans need meta['axis_names'] (the canonical mesh "
            "axis order); build them via plan_latency_collective on named "
            "axes or through comms.api")
    return tuple(names)


def _axis_groups(stages: Sequence[PlanStage],
                 mesh: FactorizedMesh) -> List[Tuple[str, int]]:
    """Contiguous runs of same-axis factor-2 exchange stages as
    ``(axis_name, num_rounds)``.  Each axis must form exactly one run: the
    planner builds chains that way and the digit bookkeeping relies on
    it."""
    groups: List[List] = []
    for s in stages:
        if s.mode != "exchange" or s.factor != 2:
            raise ValueError(
                f"exchange executor needs factor-2 exchange stages, got "
                f"factor={s.factor} mode={s.mode!r} on axis {s.axis!r}")
        if s.axis is None:
            raise ValueError("exchange stages need named mesh axes")
        if groups and groups[-1][0] == s.axis:
            groups[-1][1] += 1
        else:
            groups.append([s.axis, 1])
    run_names = [g[0] for g in groups]
    if len(set(run_names)) != len(run_names):
        raise ValueError(
            f"exchange rounds of one axis must be contiguous, got stage "
            f"axes {[s.axis for s in stages]}")
    out = []
    for name, k in groups:
        m = mesh.axis_size(name)
        if m != 1 << k:
            raise ValueError(
                f"axis {name!r} has size {m} but the plan carries {k} "
                f"factor-2 exchange rounds (needs size {1 << k})")
        out.append((name, k))
    return out


def _canonical_digits(
    names: Sequence[str], ks: dict
) -> List[Tuple[str, int]]:
    """Digit labels in canonical output order: axes in ``names`` order
    (major first), each axis's bits MSB-first."""
    return [(n, s) for n in names for s in reversed(range(ks.get(n, 0)))]


def _gather_rounds(
    buf: torch.Tensor,
    groups: Sequence[Tuple[str, int]],
    probe: Optional[Callable],
    mesh: FactorizedMesh,
) -> Tuple[torch.Tensor, List[Tuple[str, int]]]:
    """Run every gather group's rounds on ``buf`` (leading-axis block).

    Returns ``(stacked, digits)`` where ``stacked`` has one leading (2,)
    axis per round and ``digits`` labels those axes leading-to-trailing
    (newest round first, since each round stacks a new leading axis).
    """
    digits: List[Tuple[str, int]] = []
    for name, k in groups:
        idx = mesh.axis_index(name)
        before = buf
        for t in range(k):
            sig = k - 1 - t  # MSB first
            partner = idx ^ (1 << sig)
            recv = _maybe_inject(mesh.ppermute(buf, name, partner, partner),
                                 name, t + 1, mesh)
            # new digit stacks LEADING: slot 0 = the bit-0 half
            pair = (buf, recv) if (idx >> sig) & 1 == 0 else (recv, buf)
            buf = torch.stack(pair)
            digits.insert(0, (name, sig))
        if probe is not None:
            probe(before, buf, name)
    return buf, digits


def _scatter_rounds(
    buf: torch.Tensor,
    groups: Sequence[Tuple[str, int]],
    probe: Optional[Callable],
    mesh: FactorizedMesh,
) -> torch.Tensor:
    """Run every scatter group's rounds.  ``buf`` arrives with one leading
    (2,) axis per round in ROUND order (first round's digit leading); each
    round consumes the leading axis: keep my bit's half, swap the other
    with the partner, add what arrives."""
    for name, k in groups:
        idx = mesh.axis_index(name)
        before = buf
        for t in range(k):
            sig = t  # LSB first: the time-mirror of the gather rounds
            bit = (idx >> sig) & 1
            mine, other = buf[bit], buf[1 - bit]
            partner = idx ^ (1 << sig)
            recv = _maybe_inject(mesh.ppermute(other, name, partner, partner),
                                 name, t + 1, mesh)
            buf = mine + recv
        if probe is not None:
            probe(before, buf, name)
    return buf


def _finalize_gather(
    buf: torch.Tensor,
    digits: List[Tuple[str, int]],
    names: Sequence[str],
    block_ndim: int,
) -> torch.Tensor:
    """Transpose the stacked digit axes into canonical order and collapse
    them (plus the local block axis) into one leading rank-block axis: the
    tiled all_gather layout."""
    ks: dict = {}
    for n, s in digits:
        ks[n] = max(ks.get(n, 0), s + 1)
    canonical = _canonical_digits(names, ks)
    if sorted(canonical) != sorted(digits):
        raise ValueError(
            f"plan digits {sorted(digits)} do not cover the canonical "
            f"axes {list(names)}")
    K = len(digits)
    perm = tuple(digits.index(d) for d in canonical) + tuple(
        range(K, K + block_ndim))
    buf = buf.permute(perm)
    return buf.reshape((-1,) + tuple(buf.shape[K + 1:]))


def _split_canonical(
    x: torch.Tensor,
    groups: Sequence[Tuple[str, int]],
    names: Sequence[str],
) -> torch.Tensor:
    """Reshape a canonical full-length leading axis into per-digit (2,)
    axes and transpose them into the scatter ROUND order (first scatter
    round's digit leading)."""
    ks = {name: k for name, k in groups}
    canonical = _canonical_digits(names, ks)
    round_order = [(name, t) for name, k in groups for t in range(k)]
    K = len(canonical)
    n_total = 1 << K
    if x.shape[0] % n_total:
        raise ValueError(
            f"leading length {x.shape[0]} not divisible by group size "
            f"{n_total}")
    block = x.shape[0] // n_total
    buf = x.reshape((2,) * K + (block,) + tuple(x.shape[1:]))
    perm = tuple(canonical.index(d) for d in round_order) + tuple(
        range(K, buf.dim()))
    return buf.permute(perm)


def exchange_all_gather(
    y: torch.Tensor, plan: CollectivePlan, *, axis: int = 0,
    stage_probe: Optional[Callable] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Recursive-doubling all-gather: equals ``lax.all_gather(y, names,
    axis=axis, tiled=True)`` bit for bit."""
    mesh = resolve_mesh(mesh)
    names = _canonical_names(plan)
    groups = _axis_groups(plan.stages, mesh)
    if axis < 0:
        axis += y.dim()
    x = torch.movedim(y, axis, 0)
    buf, digits = _gather_rounds(x, groups, stage_probe, mesh)
    out = _finalize_gather(buf, digits, names, x.dim())
    return torch.movedim(out, 0, axis)


def exchange_reduce_scatter(
    y: torch.Tensor, plan: CollectivePlan, *, axis: int = 0,
    stage_probe: Optional[Callable] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Recursive-halving reduce-scatter: equals ``lax.psum_scatter(y,
    names, scatter_dimension=axis, tiled=True)`` up to reduction order
    (exact for exactly representable sums)."""
    mesh = resolve_mesh(mesh)
    names = _canonical_names(plan)
    groups = _axis_groups(plan.stages, mesh)
    if axis < 0:
        axis += y.dim()
    x = torch.movedim(y, axis, 0)
    buf = _split_canonical(x, groups, names)
    out = _scatter_rounds(buf, groups, stage_probe, mesh)
    return torch.movedim(out, 0, axis)


def exchange_all_reduce(
    y: torch.Tensor, plan: CollectivePlan, *, axis: int = 0,
    rs_probe: Optional[Callable] = None,
    ag_probe: Optional[Callable] = None,
    mesh: Optional[FactorizedMesh] = None,
) -> torch.Tensor:
    """Recursive halving-doubling all-reduce (scatter rounds then gather
    rounds, the plan's 2k exchange stages): equals ``lax.psum(y, names)``
    up to reduction order."""
    mesh = resolve_mesh(mesh)
    names = _canonical_names(plan)
    k = len(plan.stages) // 2
    rs_groups = _axis_groups(plan.stages[:k], mesh)
    ag_groups = _axis_groups(plan.stages[k:], mesh)
    if axis < 0:
        axis += y.dim()
    x = torch.movedim(y, axis, 0)
    buf = _split_canonical(x, rs_groups, names)
    block = _scatter_rounds(buf, rs_groups, rs_probe, mesh)
    gathered, digits = _gather_rounds(block, ag_groups, ag_probe, mesh)
    out = _finalize_gather(gathered, digits, names, block.dim())
    return torch.movedim(out, 0, axis)
