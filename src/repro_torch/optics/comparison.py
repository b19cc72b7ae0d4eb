"""Analytic algorithm comparison backend for the paper's figures.

Large-N sweeps (N up to 4096, messages to 128 MB) use the closed-form step
counts + Eq. 3 — the same granularity as the paper's own model — because full
transmission enumeration at N=4096 is O(N^2) lightpaths.  Small-N cases are
cross-checked against the schedule-level simulator in tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from ..core import steps as S
from ..core.cost_model import OpticalSystem, eq3_time
from ..core.tree import OpTreePlan, balanced_factors

__all__ = ["AlgoResult", "compare_algorithms"]


@dataclass(frozen=True)
class AlgoResult:
    algorithm: str
    n: int
    w: int
    message_bytes: float
    steps: int
    time_s: float
    collective: str = "all-gather"
    # per-stage attribution (empty when the algorithm has no closed-form
    # stage split).  For OpTree this is the exact per-stage demand of the
    # balanced plan (sums to optree_steps_exact), while `steps` keeps the
    # paper's Theorem-1 closed form (real-valued m) — they can differ by
    # the continuous-relaxation rounding; single-stage baselines agree.
    stage_steps: Tuple[int, ...] = ()
    stage_times_s: Tuple[float, ...] = ()


def _allgather_steps(algorithm: str, n: int, w: int) -> Optional[int]:
    if algorithm == "ring":
        return S.ring_steps(n, w)
    if algorithm == "ne":
        return S.neighbor_exchange_steps(n, w)
    if algorithm == "one-stage":
        return S.one_stage_steps(n, w)
    if algorithm == "wrht":
        return S.wrht_steps_formula(n, w)
    if algorithm == "wrht-paper":
        return S.wrht_steps_paper_table(n, w)
    if algorithm == "optree":
        return S.optree_optimal_steps(n, w)[1]
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _steps_for(
    algorithm: str, n: int, w: int, collective: str = "all-gather"
) -> Optional[int]:
    """Step count for a collective built from the algorithm's schedule.

    reduce-scatter: the time-reversed all-gather schedule — each step's
    transmissions run backwards carrying partial sums, so the step count is
    identical (and for OpTree the stage order is the exact reverse: the
    shrinking payload leaves the slow stages last).  all-reduce: RS then AG
    back-to-back (2x; no step sharing across the scattered boundary).
    """
    ag = _allgather_steps(algorithm, n, w)
    if ag is None or collective == "all-gather":
        return ag
    if collective == "reduce-scatter":
        return ag
    if collective == "all-reduce":
        return 2 * ag
    raise ValueError(f"unknown collective {collective!r}")


def _allgather_stage_steps(algorithm: str, n: int, w: int) -> Tuple[int, ...]:
    """Per-stage step split of the all-gather schedule, where the algorithm
    has one: OpTree's optimal plan splits over its k stages; the one-round
    baselines are a single stage.  Empty for WRHT (no closed per-round
    form in the paper)."""
    if algorithm == "optree":
        k, _ = S.optree_optimal_steps(n, w)
        plan = OpTreePlan(n, balanced_factors(n, k))
        return tuple(
            math.ceil(S.optree_stage_demand(plan, j) / w)
            for j in range(1, plan.k + 1)
        )
    if algorithm in ("ring", "ne", "one-stage"):
        steps = _allgather_steps(algorithm, n, w)
        return (steps,) if steps is not None else ()
    return ()


def _stage_steps_for(
    algorithm: str, n: int, w: int, collective: str
) -> Tuple[int, ...]:
    """Stage attribution for the collective: RS mirrors the AG split (time
    reversal — the shrinking payload leaves the slow stages last), AR is
    the RS split followed by the AG split."""
    ag = _allgather_stage_steps(algorithm, n, w)
    if collective == "all-gather":
        return ag
    if collective == "reduce-scatter":
        return tuple(reversed(ag))
    if collective == "all-reduce":
        return tuple(reversed(ag)) + ag
    return ()


def compare_algorithms(
    n: int,
    w: int,
    message_bytes: float,
    sys: OpticalSystem,
    algorithms: Iterable[str] = ("optree", "wrht", "ring", "ne", "one-stage"),
    *,
    collective: str = "all-gather",
) -> Dict[str, AlgoResult]:
    out: Dict[str, AlgoResult] = {}
    for algo in algorithms:
        steps = _steps_for(algo, n, w, collective)
        if steps is None:
            continue
        stage_steps = _stage_steps_for(algo, n, w, collective)
        per_step = eq3_time(sys, message_bytes, 1)
        out[algo] = AlgoResult(
            algorithm=algo,
            n=n,
            w=w,
            message_bytes=message_bytes,
            steps=steps,
            time_s=eq3_time(sys, message_bytes, steps),
            collective=collective,
            stage_steps=stage_steps,
            stage_times_s=tuple(per_step * s for s in stage_steps),
        )
    return out
