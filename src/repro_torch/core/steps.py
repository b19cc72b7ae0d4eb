"""Closed-form communication-step counts (paper §III-D.2, Table I, Lemma 1).

All functions count *communication steps* (time slots): one step = every
wavelength carries at most one data item of size d, conflict-free.

Two families:
  * ``*_thm1`` / Table-I closed forms — the paper's analytic expressions
    (real-valued m = N^(1/k), merged ceilings).
  * ``optree_steps_exact`` — per-stage integer accounting for a concrete
    ``OpTreePlan`` (what the generated schedule actually achieves; equals the
    closed form for perfect powers).

Table-I reproduction notes (also in DESIGN.md):
  * OpTree / Ring / NE reproduce the printed numbers exactly.
  * One-stage: the printed formula ceil(N^2/(8w)) gives 2048 at
    (N=1024, w=64); the paper prints 128 (consistent with w=N, a typo).  The
    paper's own Fig.-4 claim ("96.85% average reduction vs one-stage") matches
    the *formula*, not the printed 128 — we follow the formula.
  * WRHT: the footnote formula with p=2w+1 and any natural base for theta
    cannot produce the printed 259; we implement the formula literally
    (theta = ceil(log_p N)) and pin the paper's printed value separately.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from .tree import OpTreePlan, balanced_factors, optimal_depth_argmin

__all__ = [
    "lemma1_wavelengths_line",
    "lemma1_wavelengths_ring",
    "one_stage_subset_wavelengths_ring",
    "one_stage_subset_wavelengths_line",
    "optree_stage_demand",
    "optree_steps_exact",
    "optree_steps_thm1",
    "optree_optimal_steps",
    "ring_steps",
    "neighbor_exchange_steps",
    "one_stage_steps",
    "wrht_steps_formula",
    "wrht_steps_paper_table",
]


# --------------------------------------------------------------------------
# Lemma 1: one-stage all-to-all wavelength demand
# --------------------------------------------------------------------------
def lemma1_wavelengths_line(n: int) -> int:
    """Minimum wavelengths for one-stage all-to-all on an n-node *line*."""
    return (n * n) // 4


def lemma1_wavelengths_ring(n: int) -> int:
    """Minimum wavelengths for one-stage all-to-all on an n-node *ring*."""
    return math.ceil(n * n / 8)


# The per-subset demands OpTree uses (m uniformly spaced participants):
def one_stage_subset_wavelengths_ring(m: int) -> int:
    return math.ceil(m * m / 8)


def one_stage_subset_wavelengths_line(m: int) -> int:
    return (m * m) // 4


# --------------------------------------------------------------------------
# OpTree (Theorem 1 + exact per-plan accounting)
# --------------------------------------------------------------------------
def optree_stage_demand(plan: OpTreePlan, stage: int) -> int:
    """Total wavelength demand of ``stage`` (ring-wide concurrent lightpaths).

    Stage 1: ceil(N/m_1) position-subsets share the whole ring, each needs
    ceil(m_1^2/8) wavelengths, one item per node.
    Stage j>=2: parents are link-disjoint segments; within a parent,
    ceil(N/prod_{i<=j} m_i) position-subsets share the segment, each needs
    floor(m_j^2/4) wavelengths *per item*, and every node ships
    prod_{i<j} m_i items.
    """
    if not (1 <= stage <= plan.k):
        raise ValueError("bad stage")
    m = plan.factors[stage - 1]
    items = 1
    for f in plan.factors[: stage - 1]:
        items *= f
    positions = plan.sizes[stage - 1]  # subsets sharing links inside a parent
    if stage == 1:
        return positions * one_stage_subset_wavelengths_ring(m) * items
    return positions * one_stage_subset_wavelengths_line(m) * items


def optree_steps_exact(plan: OpTreePlan, w: int) -> int:
    """Sum over stages of ceil(stage_demand / w) — the schedule's step count."""
    return sum(
        math.ceil(optree_stage_demand(plan, j) / w) for j in range(1, plan.k + 1)
    )


def optree_steps_thm1(n: int, k: int, w: int) -> int:
    """Theorem 1: S = ceil((2k-1) * N^(1+1/k) / (8w))  (real-valued m)."""
    if k < 1:
        raise ValueError("k >= 1")
    if k == 1:
        return one_stage_steps(n, w)
    return math.ceil((2 * k - 1) * n ** (1.0 + 1.0 / k) / (8.0 * w))


def optree_optimal_steps(n: int, w: int) -> Tuple[int, int]:
    """(k_opt, steps) minimizing Theorem 1 over integer k (paper Thm 2/3)."""
    k = optimal_depth_argmin(n, w)
    return k, optree_steps_thm1(n, k, w)


# --------------------------------------------------------------------------
# Baselines (Table I)
# --------------------------------------------------------------------------
def ring_steps(n: int, w: int = 64) -> int:
    """Classic ring all-gather: N-1 steps (one neighbour hop per step)."""
    del w
    return n - 1


def neighbor_exchange_steps(n: int, w: int = 64) -> int:
    """Neighbor-Exchange all-gather: N/2 steps (even/odd pair exchanges)."""
    del w
    return math.ceil(n / 2)


def one_stage_steps(n: int, w: int) -> int:
    """One-stage model on a ring: ceil(N^2 / (8w)) (see module docstring)."""
    return math.ceil(lemma1_wavelengths_ring(n) / w)


def wrht_steps_formula(n: int, w: int) -> int:
    """WRHT extended to all-gather, per the paper's Table-I footnote, read
    literally: p = 2w+1, theta = ceil(log_p N).

    steps = ceil((N-p)/(p-1)) + ceil(2(theta-1)N/p) + 1
    """
    p = 2 * w + 1
    if n <= p:
        return 1
    theta = math.ceil(math.log(n) / math.log(p))
    return math.ceil((n - p) / (p - 1)) + math.ceil(2 * (theta - 1) * n / p) + 1


#: The paper's *printed* Table-I WRHT value(s); see module docstring.
_WRHT_PAPER: dict = {(1024, 64): 259}


def wrht_steps_paper_table(n: int, w: int) -> Optional[int]:
    return _WRHT_PAPER.get((n, w))


# --------------------------------------------------------------------------
# Convenience: the full Table-I row set
# --------------------------------------------------------------------------
def table1(n: int = 1024, w: int = 64) -> dict:
    k, s = optree_optimal_steps(n, w)
    plan = OpTreePlan(n, balanced_factors(n, k))
    return {
        "Ring": ring_steps(n, w),
        "NE": neighbor_exchange_steps(n, w),
        "WRHT(formula)": wrht_steps_formula(n, w),
        "WRHT(paper)": wrht_steps_paper_table(n, w),
        "One-Stage": one_stage_steps(n, w),
        f"OpTree(k*={k})": s,
        f"OpTree-exact(factors={plan.factors})": optree_steps_exact(plan, w),
    }
