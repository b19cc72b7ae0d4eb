"""IR-interpreting executor: run one CollectivePlan on this rank's shard.

This is consumer (3) of the unified IR (``core.plan_ir``): the engine does
not re-derive stage orders, chunk counts, or per-stage execution modes at
the call site.  ``execute_plan`` reads them off the plan and maps its stage
chain onto the per-rank primitives:

  * plan mode ``chunked`` -> the ``num_chunks``-chunk wavefront over
    blocking whole-stage collectives (``staged_collectives``);
  * plan mode ``hybrid`` -> the same chunk wavefront run OVER the per-hop
    stage executors (``ring_executor.hybrid_*``);
  * otherwise -> the staged executors of ``ring_executor`` with one
    ``stage_modes`` entry per stage: a stage whose effective IR mode is
    ``perhop`` runs as a ppermute ring, the rest as the blocking collective
    (under plan mode ``oneshot`` every stage is blocking,
    ``effective_stage_mode``).

Because the same plan object is priced (``core.cost_model.price``), lowered
to lightpaths (``core.schedule.schedule_from_ir``) and executed here,
planner decisions and executor behaviour cannot drift.  Outputs are
bit-identical to the one-shot collectives (AG and a2a exactly; RS and AR
for exactly representable sums): ``tests/test_torch_comms_exec.py`` holds
them to the reference's executors and to numpy.

The verified executor (``execute_plan_verified``: per-stage checksums,
bounded retry, one-shot fallback) is the fault layer, ROADMAP A10.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.plan_ir import CollectivePlan, PlanStage, effective_stage_mode
from .exchange_executor import (
    exchange_all_gather,
    exchange_all_reduce,
    exchange_reduce_scatter,
)
from .mesh_utils import FactorizedMesh, resolve_mesh
from .ring_executor import (
    hybrid_all_gather,
    hybrid_all_reduce,
    hybrid_all_to_all,
    hybrid_reduce_scatter,
    perhop_all_gather,
    perhop_all_to_all,
    perhop_reduce_scatter,
)
from .staged_allgather import _merge_device_axis
from .staged_collectives import (
    staged_all_gather_chunked,
    staged_all_reduce,
    staged_all_to_all,
    staged_reduce_scatter,
)

__all__ = [
    "execute_plan",
    "oneshot_reference",
    "plan_axis_names",
]


def plan_axis_names(plan: CollectivePlan) -> Tuple[str, ...]:
    """Canonical (major-first mesh order) axis names the plan gathers over,
    stamped into ``plan.meta`` by ``comms.staged_collectives.plan_collectives``."""
    names = plan.meta.get("axis_names")
    if not names:
        raise ValueError(
            "plan has no meta['axis_names']; build engine plans via "
            "plan_collectives (paper-world plans lower through "
            "core.schedule.schedule_from_ir instead)"
        )
    return tuple(names)


def _executor_modes(
    plan: CollectivePlan, stages: Sequence[PlanStage]
) -> Tuple[str, ...]:
    """Per-stage ``ring_executor`` stage_modes ("ring"/"oneshot") for the
    stages' EFFECTIVE hop structure under the plan-level mode."""
    return tuple(
        "ring" if effective_stage_mode(plan, s) == "perhop" else "oneshot"
        for s in stages
    )


def execute_plan(y: torch.Tensor, plan: CollectivePlan, *, axis: int = 0,
                 stage_probe: Optional[Callable] = None,
                 mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """Execute ``plan`` on this rank's local array ``y``.

    * ``ag``: ``y`` is the local shard; returns the full gather (equals
      ``lax.all_gather(y, names, axis=axis, tiled=True)`` bit for bit).
    * ``rs``: ``y`` is the full-length local addend; returns this rank's
      canonical block of the sum (equals ``lax.psum_scatter``).
    * ``ar``: returns ``lax.psum(y, names)`` (up to reduction order for
      per-hop ring stages).
    * ``a2a``: ``y`` is the full local exchange buffer (N destination
      blocks along ``axis``); returns the block transpose (equals
      ``lax.all_to_all(y, names, split_axis=axis, concat_axis=axis,
      tiled=True)`` bit for bit).

    ``stage_probe(before, after, name, kind)`` is invoked once per stage on
    the per-hop (non-chunked) paths with the stage's input/output and the
    stage's traffic kind ("ag"/"rs"/"a2a").  The chunked/hybrid wavefronts
    do not expose stage boundaries.
    """
    mesh = resolve_mesh(mesh)
    names = plan_axis_names(plan)
    coll = plan.collective
    chunked = plan.mode == "chunked" and plan.num_chunks > 1
    # a one-chunk hybrid degenerates to the per-hop path (same stages, no
    # wavefront), matching ``CollectivePlan.with_chunks`` normalization
    hybrid = plan.mode == "hybrid" and plan.num_chunks > 1

    def probe_for(kind: str) -> Optional[Callable]:
        if stage_probe is None:
            return None
        return lambda before, after, name: stage_probe(before, after, name, kind)

    if any(s.mode == "exchange" for s in plan.stages):
        # latency-regime plans: recursive-doubling pairwise rounds.  They
        # are single-shot by construction: the planner never chunks them
        if plan.num_chunks > 1:
            raise ValueError(
                f"exchange (latency) plans execute single-shot, got "
                f"num_chunks={plan.num_chunks}")
        if coll == "ag":
            return exchange_all_gather(
                y, plan, axis=axis, stage_probe=probe_for("ag"), mesh=mesh)
        if coll == "rs":
            return exchange_reduce_scatter(
                y, plan, axis=axis, stage_probe=probe_for("rs"), mesh=mesh)
        if coll == "ar":
            return exchange_all_reduce(
                y, plan, axis=axis, rs_probe=probe_for("rs"),
                ag_probe=probe_for("ag"), mesh=mesh)
        raise ValueError(
            f"exchange stages unsupported for collective {coll!r}")

    staged = {"ag": staged_all_gather_chunked, "rs": staged_reduce_scatter,
              "a2a": staged_all_to_all}
    hybrids = {"ag": hybrid_all_gather, "rs": hybrid_reduce_scatter,
               "a2a": hybrid_all_to_all}
    perhop = {"ag": perhop_all_gather, "rs": perhop_reduce_scatter,
              "a2a": perhop_all_to_all}
    if coll in staged:
        order = plan.axes
        if chunked:
            return staged[coll](y, names, stage_order=order, axis=axis,
                                num_chunks=plan.num_chunks, mesh=mesh)
        if hybrid:
            return hybrids[coll](y, names, stage_order=order, axis=axis,
                                 num_chunks=plan.num_chunks,
                                 stage_modes=_executor_modes(plan, plan.stages),
                                 mesh=mesh)
        return perhop[coll](y, names, stage_order=order, axis=axis,
                            stage_modes=_executor_modes(plan, plan.stages),
                            stage_probe=probe_for(coll), mesh=mesh)

    if coll == "ar":
        k = len(plan.stages) // 2
        rs_stages, ag_stages = plan.stages[:k], plan.stages[k:]
        rs_order = tuple(st.axis for st in rs_stages)
        if chunked:
            return staged_all_reduce(
                y, names, rs_order=rs_order, axis=axis,
                num_chunks=plan.num_chunks, mesh=mesh)
        if hybrid:
            return hybrid_all_reduce(
                y, names, rs_order=rs_order, axis=axis,
                num_chunks=plan.num_chunks,
                stage_modes=_executor_modes(plan, plan.stages), mesh=mesh)
        y = perhop_reduce_scatter(
            y, names, stage_order=rs_order, axis=axis,
            stage_modes=_executor_modes(plan, rs_stages),
            stage_probe=probe_for("rs"), mesh=mesh)
        return perhop_all_gather(
            y, names, stage_order=tuple(st.axis for st in ag_stages),
            axis=axis, stage_modes=_executor_modes(plan, ag_stages),
            stage_probe=probe_for("ag"), mesh=mesh)

    raise ValueError(f"unknown collective {coll!r}")


def oneshot_reference(y: torch.Tensor, plan: CollectivePlan, *,
                      axis: int = 0,
                      mesh: Optional[FactorizedMesh] = None) -> torch.Tensor:
    """The flat one-shot ``torch.distributed`` collective for ``plan``, over
    the process group of all its axes: bit-identical to what the staged
    executor produces (AG/A2A exactly; RS/AR for exactly representable
    sums)."""
    mesh = resolve_mesh(mesh)
    names = plan_axis_names(plan)
    coll = plan.collective
    if axis < 0:
        axis += y.dim()
    if coll == "ag":
        return _merge_device_axis(mesh.all_gather(y, names), axis)
    if coll == "rs":
        out = mesh.psum_scatter(torch.movedim(y, axis, 0), names)
        return torch.movedim(out, 0, axis)
    if coll == "ar":
        return mesh.psum(y, names)
    if coll == "a2a":
        return mesh.all_to_all(y, names, axis)
    raise ValueError(f"unknown collective {coll!r}")
