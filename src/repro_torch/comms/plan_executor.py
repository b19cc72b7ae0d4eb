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

``execute_plan_verified`` is the fault layer on top: per-stage and
whole-collective conservation checksums, bounded retry, and the one-shot
fallback, selected per rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

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
    "execute_plan_verified",
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


# --------------------------------------------------------------------------
# verified execution: per-stage checksums, bounded retry, one-shot fallback
# --------------------------------------------------------------------------

def _close(a: torch.Tensor, b: torch.Tensor, tol: float) -> torch.Tensor:
    if tol == 0.0:
        return a == b
    scale = torch.clamp(torch.maximum(a.abs(), b.abs()), min=1.0)
    return (a - b).abs() <= tol * scale


def _group_sum(t: torch.Tensor, names, mesh: FactorizedMesh) -> torch.Tensor:
    """``lax.psum(jnp.sum(t), names)``: this rank's total summed over the
    group of ``names``, as a 0-d tensor."""
    return mesh.psum(t.sum().reshape(1), names).reshape(())


def _conservation_ok(y, out, plan, names, tol, mesh) -> torch.Tensor:
    """Whole-collective conservation checksum.  All four collectives
    preserve the group's total mass; AG and AR additionally deliver the
    full total to EVERY rank, so their check is per rank (a rank whose
    gather lost a block fails locally)."""
    tin = _group_sum(y, names, mesh)
    if plan.collective in ("ag", "ar"):
        return _close(out.sum(), tin, tol)
    return _close(_group_sum(out, names, mesh), tin, tol)


def execute_plan_verified(
    y: torch.Tensor,
    plan: CollectivePlan,
    *,
    axis: int = 0,
    retries: int = 1,
    tol: float = 0.0,
    mesh: Optional[FactorizedMesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Checksummed execution with bounded retry and graceful degradation.

    Runs ``plan`` ``retries + 1`` times; each attempt is verified by
    per-stage conservation checksums (via the ``stage_probe`` hook on the
    per-hop paths: an AG stage must deliver the stage group's full mass to
    every member, RS/A2A stages must preserve the group total) plus the
    whole-collective checksum.  The result is the FIRST attempt whose every
    checksum passes on this rank; if none passes, the bit-identical
    one-shot collective (:func:`oneshot_reference`) is selected instead:
    degraded throughput, never corrupted data.

    Every rank runs every attempt and the one-shot, then selects with
    ``torch.where``, as the reference's traced program does on every
    device.  The verdicts are per rank (an AG/AR check, or a fault on one
    ring position, can fail some ranks and not others), so a rank that
    stopped at its first clean attempt would issue fewer collectives than
    its peers and hang the group.

    ``tol`` is the relative checksum tolerance; the default ``0.0`` demands
    exact equality, which holds for exactly representable sums (the chaos
    harness uses integer-valued payloads).  Float rounding with ``tol=0``
    can only cause a spurious *fallback*, never a wrong result.

    Returns ``(out, diag)``; ``diag["attempt_ok"]`` is this rank's
    per-attempt verdict vector, ``diag["used_fallback"]`` the 0-d bool that
    no attempt survived here, and ``diag["stage_ok"]`` (per-hop paths only)
    the (attempt, stage) checksum matrix.  They are tensors on ``y``'s
    device: reading them is the caller's host synchronisation.
    """
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    mesh = resolve_mesh(mesh)
    names = plan_axis_names(plan)
    attempts, attempt_oks, stage_ok_rows = [], [], []
    for _ in range(retries + 1):
        stage_oks: list = []

        def probe(before, after, name, kind, _oks=stage_oks):
            tin = _group_sum(before, name, mesh)
            if kind == "ag":
                ok = _close(after.sum(), tin, tol)
            else:  # rs / a2a: stage-group total conservation
                ok = _close(_group_sum(after, name, mesh), tin, tol)
            _oks.append(ok)

        out = execute_plan(y, plan, axis=axis, stage_probe=probe, mesh=mesh)
        ok = _conservation_ok(y, out, plan, names, tol, mesh)
        for s_ok in stage_oks:
            ok = torch.logical_and(ok, s_ok)
        attempts.append(out)
        attempt_oks.append(ok)
        stage_ok_rows.append(stage_oks)
    out = oneshot_reference(y, plan, axis=axis, mesh=mesh)
    for a_out, a_ok in reversed(list(zip(attempts, attempt_oks))):
        out = torch.where(a_ok, a_out, out)
    attempt_ok = torch.stack(attempt_oks)
    diag: Dict[str, torch.Tensor] = {
        "attempt_ok": attempt_ok,
        "used_fallback": torch.logical_not(attempt_ok.any()),
    }
    if stage_ok_rows[0]:
        diag["stage_ok"] = torch.stack([torch.stack(row) for row in stage_ok_rows])
    return out, diag
