"""m-ary tree / stage-group algebra for OpTree (paper §III-D).

An OpTree plan factorizes the N ring nodes into ``factors = (m_1, ..., m_k)``
with ``prod(factors) == N``.  Stage ``j`` (1-indexed) partitions every
level-(j-1) group (a contiguous ring segment) into ``m_j`` children and runs
one-stage all-to-all broadcast inside the "same position across siblings"
subsets.  The paper's perfect-power case is ``factors == (m,)*k``; the mixed
radix generalization is what the JAX mesh-axis adaptation needs (a device axis
is factorized, not necessarily into equal factors).

Node coordinates are mixed-radix, *major first*:

    p = c_1 * sz_1 + c_2 * sz_2 + ... + c_k * sz_k,   sz_j = prod_{i>j} m_i

After stage j a node holds exactly the items of all peers that agree with it
on coordinates c_{j+1} .. c_k  (proof: induction, see DESIGN.md §2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator, Optional, Sequence, Tuple

__all__ = [
    "optimal_depth_thm2",
    "optimal_depth_argmin",
    "balanced_factors",
    "OpTreePlan",
]


def optimal_depth_thm2(n: int, *, rounding: str = "round") -> int:
    """Theorem 2: k* = [ (ln N + sqrt(ln N (ln N - 2))) / 2 ].

    The paper writes the ceiling operator but calls it "integer rounding"; its
    own Fig. 4 optima (6/6/7/8 for N=512/1024/2048/4096) match *round*, while
    Table I's k*=7 for N=1024 matches *ceil* (both give 70 steps there).  We
    default to round and expose both.
    """
    if n <= 1:
        return 1
    ln = math.log(n)
    if ln <= 2.0:
        return 1
    x = (ln + math.sqrt(ln * (ln - 2.0))) / 2.0
    if rounding == "ceil":
        return max(1, math.ceil(x))
    if rounding == "round":
        return max(1, round(x))
    raise ValueError(f"rounding must be 'round' or 'ceil', got {rounding!r}")


def optimal_depth_argmin(n: int, w: int, *, steps_fn=None) -> int:
    """Integer argmin over k of the Theorem-1 step count (ties -> smaller k).

    This is the operationally correct optimum (what Fig. 4 sweeps); Theorem 2
    is its continuous approximation.
    """
    from . import steps as _steps  # local import to avoid a cycle

    fn = steps_fn or (lambda k: _steps.optree_steps_thm1(n, k, w))
    kmax = max(1, math.ceil(math.log2(max(n, 2))))
    best_k, best_s = 1, fn(1)
    for k in range(2, kmax + 1):
        s = fn(k)
        if s < best_s:
            best_k, best_s = k, s
    return best_k


@lru_cache(maxsize=4096)
def _divisors(n: int) -> Tuple[int, ...]:
    out = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    out += [n // d for d in reversed(out) if d * d != n]
    return tuple(out)


def balanced_factors(n: int, k: int) -> Tuple[int, ...]:
    """Factor ``n`` into ``k`` integer factors with product exactly ``n``,
    as close to n^(1/k) as possible (minimizing max factor, then spread).

    Factors of 1 are dropped, so the returned tuple may be shorter than k
    (e.g. prime n always returns (n,)).
    """
    if n <= 0:
        raise ValueError("n must be positive")
    if n == 1:
        return (1,)
    if k <= 1:
        return (n,)

    best: Optional[Tuple[int, ...]] = None

    def key(fs: Tuple[int, ...]):
        return (max(fs), sum(f * f for f in fs))

    def rec(rem: int, slots: int, cur: Tuple[int, ...]):
        nonlocal best
        if slots == 1 or rem == 1:
            cand = tuple(sorted(cur + ((rem,) if rem > 1 else ()), reverse=True))
            if not cand:
                cand = (1,)
            if best is None or key(cand) < key(best):
                best = cand
            return
        target = rem ** (1.0 / slots)
        divs = [d for d in _divisors(rem) if d > 1]
        # try divisors closest to the balanced target first; bound the branch
        divs.sort(key=lambda d: abs(d - target))
        for d in divs[:6]:
            rec(rem // d, slots - 1, cur + (d,))

    rec(n, k, ())
    assert best is not None
    out = tuple(f for f in best if f > 1)
    return out if out else (1,)


def mixed_radix_sizes(factors: Sequence[int]) -> Tuple[int, ...]:
    """sz_j = prod_{i>j} m_i  (size of a level-j group), j = 1..k."""
    sizes = []
    acc = 1
    for m in reversed(factors):
        sizes.append(acc)
        acc *= m
    return tuple(reversed(sizes))


@dataclass(frozen=True)
class Subset:
    """One all-to-all subset in one stage."""

    members: Tuple[int, ...]  # node ids, ascending ring position
    segment: Optional[Tuple[int, int]]  # (start, length) of the parent ring
    # segment for stage >= 2 (line routing); None => whole ring (stage 1)


@dataclass(frozen=True)
class OpTreePlan:
    """A concrete k-stage factorization of an N-node ring."""

    n: int
    factors: Tuple[int, ...]

    def __post_init__(self):
        prod = 1
        for m in self.factors:
            if m < 1:
                raise ValueError("factors must be >= 1")
            prod *= m
        if prod != self.n:
            raise ValueError(
                f"prod(factors)={prod} != n={self.n}; pick an exact factorization"
            )

    # -- basic algebra ------------------------------------------------------
    @property
    def k(self) -> int:
        return len(self.factors)

    @property
    def sizes(self) -> Tuple[int, ...]:
        """Group size *below* each stage: sizes[j-1] = nodes per level-j group."""
        return mixed_radix_sizes(self.factors)

    def coords(self, p: int) -> Tuple[int, ...]:
        cs = []
        for sz, m in zip(self.sizes, self.factors):
            cs.append((p // sz) % m)
        return tuple(cs)

    def node(self, coords: Sequence[int]) -> int:
        return sum(c * sz for c, sz in zip(coords, self.sizes))

    # -- stage structure ----------------------------------------------------
    def subsets(self, stage: int) -> Iterator[Subset]:
        """All all-to-all subsets of ``stage`` (1-indexed)."""
        if not (1 <= stage <= self.k):
            raise ValueError(f"stage must be in [1, {self.k}]")
        m = self.factors[stage - 1]
        child_sz = self.sizes[stage - 1]
        parent_sz = child_sz * m
        n_parents = self.n // parent_sz
        for parent in range(n_parents):
            start = parent * parent_sz
            for pos in range(child_sz):
                members = tuple(start + g * child_sz + pos for g in range(m))
                seg = None if stage == 1 else (start, parent_sz)
                yield Subset(members=members, segment=seg)

    def items_held_after(self, stage: int, p: int) -> Tuple[int, ...]:
        """Item ids node p holds after completing ``stage`` (0 = initial)."""
        cs = self.coords(p)
        held = []
        for q in range(self.n):
            cq = self.coords(q)
            if cq[stage:] == cs[stage:]:
                held.append(q)
        return tuple(held)

    def items_to_send(self, stage: int, p: int) -> Tuple[int, ...]:
        """Items node p broadcasts during ``stage`` = holdings after stage-1."""
        return self.items_held_after(stage - 1, p)

    # -- convenience --------------------------------------------------------
    @staticmethod
    def balanced(n: int, k: Optional[int] = None, w: int = 64) -> "OpTreePlan":
        """The paper's plan: optimal depth (argmin of Thm 1) + balanced factors."""
        if k is None:
            k = optimal_depth_argmin(n, w)
        return OpTreePlan(n=n, factors=balanced_factors(n, k))

    def to_ir(
        self,
        *,
        shard_bytes: float = 1.0,
        link=None,
        stage_modes: Optional[Sequence[str]] = None,
    ):
        """Lift this paper plan into the unified :class:`CollectivePlan` IR.

        Stages default to ``oneshot`` (the paper's all-to-all broadcast
        rounds); ``stage_modes`` overrides per stage (``"perhop"`` turns a
        stage into m-1 ring hops).  ``link`` optionally attaches one
        LinkSpec to every stage so the electrical backend of
        ``cost_model.price`` can price it too.
        """
        from .plan_ir import CollectivePlan, PlanStage  # local: avoid a cycle

        modes = tuple(stage_modes) if stage_modes is not None else ("oneshot",) * self.k
        if len(modes) != self.k:
            raise ValueError(f"stage_modes must have {self.k} entries, got {modes}")
        stages = []
        payload = float(shard_bytes)
        for m, mode in zip(self.factors, modes):
            stages.append(PlanStage(factor=m, mode=mode, payload_bytes=payload,
                                    link=link))
            payload *= m
        return CollectivePlan(
            collective="ag",
            n=self.n,
            shard_bytes=float(shard_bytes),
            stages=tuple(stages),
            meta={"source": "optree", "factors": self.factors},
        )
