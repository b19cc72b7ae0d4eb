"""Unified CollectivePlan IR — ONE plan object from scheduler to executor.

The repo used to hold two disjoint plan worlds: the paper side
(``core.tree.OpTreePlan`` → ``core.schedule`` Tx lightpaths → the Eq.-3
optical simulator) and the engine side (``core.planner`` stage plans →
``comms`` shard_map executors), each priced by its own cost model.  This
module is the bridge: a single IR

    CollectivePlan
      └─ PlanStage(factor, axis, link, mode ∈ {oneshot, perhop})
           └─ Hop
                └─ Transfer(src, dst, item, bytes)

with builders from both worlds (``OpTreePlan.to_ir()``,
``HopSchedule.to_ir()``) and consumers in all four layers:

  * ``core.cost_model.price(plan, model)`` — one pricing entry point for
    the LinkSpec alpha/bandwidth model AND the paper's optical Eq.-3 model;
  * ``core.schedule.schedule_from_ir(plan, w)`` — lowers a plan to Tx
    lightpaths for step-accurate, conflict-checked validation in
    ``optics.simulator.simulate``;
  * ``comms.plan_executor.execute_plan`` — the JAX executor interprets the
    plan's stages directly (no re-derivation, no drift);
  * ``launch/perf.py --collectives`` / ``benchmarks/run.py`` — report
    modeled-electrical, modeled-optical and measured time off the same
    plan object.

Semantics.  ``stages`` are in EXECUTION order.  A plan with factors
(f_1..f_k) places participant p at ring/mixed-radix position with the
first-executed factor most significant, which makes the transfer structure
of an all-gather plan literally ``OpTreePlan(n, factors)``: stage j gathers
coordinate c_j inside "same position across siblings" subsets.  The dual
collectives reuse the gather algebra by time reversal: a reduce-scatter's
transfer structure is the mirrored all-gather run backwards (identical hop
and step counts — see ``optics/comparison.py``), an all-reduce is RS then
AG.

``PlanStage.mode`` is the hop structure: ``"oneshot"`` — the stage is one
synchronized all-to-all round (paper §III-D; XLA blocking collective on the
engine side); ``"perhop"`` — the stage runs as ``factor-1`` double-buffered
ring hops (``comms.ring_executor``).  ``CollectivePlan.mode`` is the
plan-level execution decision (``oneshot`` / ``chunked`` / ``perhop`` /
``hybrid``); ``num_chunks`` carries the wavefront chunk count for the
chunked and hybrid modes.  ``hybrid`` is the perhop-chunked combination:
the C-chunk wavefront flows OVER per-hop ring stages, so each pipeline
stage is the overlapped ring (or the blocking collective where the stage's
hop structure says ``oneshot``) on a 1/C-payload chunk — dominated by
neither pure mode, never worse than either (the makespan of elementwise-
smaller stage times over the same chunk candidates).
Hops/transfers are materialized lazily (``expand_hops``) — consumers that
only price or execute a plan never pay the O(N^2) enumeration.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .tree import OpTreePlan

__all__ = [
    "Transfer",
    "Hop",
    "PlanStage",
    "CollectivePlan",
    "CollectiveKind",
    "COLLECTIVES",
    "collective_kind",
    "optical_message_bytes",
    "expand_hops",
    "stage_hops",
    "gather_chain",
    "effective_stage_mode",
]

STAGE_MODES = ("oneshot", "perhop", "exchange")
PLAN_MODES = ("oneshot", "chunked", "perhop", "hybrid")


# --------------------------------------------------------------------------
# collective registry — the stage algebra of each collective kind
# --------------------------------------------------------------------------

def _gather_payloads(shard_bytes: float, factors: Sequence[int]) -> List[float]:
    """Entering payload of each gather stage: grows by the already-gathered
    prefix (stage j moves shard · prod_{i<j} f_i per peer)."""
    out: List[float] = []
    payload = float(shard_bytes)
    for f in factors:
        out.append(payload)
        payload *= f
    return out


def _scatter_payloads(shard_bytes: float, factors: Sequence[int]) -> List[float]:
    """Leaving payload of each scatter stage — the gather law run backwards
    (stage j of an RS with execution factors g_1..g_k moves
    shard · prod_{i>j} g_i per peer)."""
    out: List[float] = []
    payload = float(shard_bytes) * math.prod(factors)
    for f in factors:
        payload /= f
        out.append(payload)
    return out


@dataclass(frozen=True)
class CollectiveKind:
    """Stage-algebra descriptor for one collective kind — the registry entry
    that replaces the string-literal ``ag|rs|ar`` special-casing.

    ``traffic`` — the per-stage hop structure family:

      * ``"gather"`` — stage j broadcasts each member's entering block within
        its "same position across siblings" subset; the payload grows
        (forward) or shrinks (reversed) with the already-covered factors;
      * ``"exchange"`` — stage j transposes ONE mixed-radix digit of the
        (origin, destination) block grid: every member sends a ``1/m`` slice
        of its constant-``n``-block residency to every sibling (the scaled-
        payload all-to-all semantics — nothing accumulates across stages).

    ``chain`` — how execution-order stages map onto the gather-equivalent
    lowering chain: ``"forward"`` (ag, a2a), ``"reversed"`` (rs — the
    time-reversed mirror AG), ``"two_phase"`` (ar — an RS half then an AG
    half; consumers split at ``k = len(stages) // 2``).

    ``dual`` — the kind whose chain is this one's time reversal (rs ↔ ag);
    ``a2a`` is self-dual: an all-to-all run backwards is the inverse
    all-to-all, with identical hop and step structure.
    """

    name: str
    traffic: str  # "gather" | "exchange"
    chain: str  # "forward" | "reversed" | "two_phase"
    dual: Optional[str] = None

    @property
    def two_phase(self) -> bool:
        return self.chain == "two_phase"

    def expected_factor_product(self, n: int) -> int:
        """What the plan's stage factors must multiply to (two-phase kinds
        span both mirrored chains)."""
        return n * n if self.two_phase else n

    def item_count(self, n: int) -> int:
        """Size of the schedule item space: origin shards for gather
        traffic, ``n²`` (origin, destination) blocks for exchange traffic."""
        return n * n if self.traffic == "exchange" else n

    def message_bytes(self, shard_bytes: float, n: int) -> float:
        """Bytes of ONE schedule item — the per-step optical message size
        (a whole shard for gather traffic; a ``1/n`` block for exchange)."""
        return shard_bytes / n if self.traffic == "exchange" else shard_bytes

    def stage_payloads(
        self, shard_bytes: float, factors: Sequence[int]
    ) -> Tuple[float, ...]:
        """The payload-per-stage law: the per-peer ``p`` each EXECUTED stage
        moves, as fed to the ``(f-1)·(α + p/B)`` barrier and
        ``max((f-1)·p/B + α, (f-1)·α + p/B)`` overlap models."""
        factors = tuple(factors)
        if self.traffic == "exchange":
            return tuple(shard_bytes / f for f in factors)
        if self.two_phase:
            k = len(factors) // 2
            return tuple(
                _scatter_payloads(shard_bytes, factors[:k])
                + _gather_payloads(shard_bytes, factors[k:])
            )
        if self.chain == "reversed":
            return tuple(_scatter_payloads(shard_bytes, factors))
        return tuple(_gather_payloads(shard_bytes, factors))


COLLECTIVES: Dict[str, CollectiveKind] = {
    "ag": CollectiveKind("ag", traffic="gather", chain="forward", dual="rs"),
    "rs": CollectiveKind("rs", traffic="gather", chain="reversed", dual="ag"),
    "ar": CollectiveKind("ar", traffic="gather", chain="two_phase"),
    "a2a": CollectiveKind("a2a", traffic="exchange", chain="forward", dual="a2a"),
}


def collective_kind(name: str) -> CollectiveKind:
    """Registry lookup; raises with the registered names on a miss."""
    try:
        return COLLECTIVES[name]
    except KeyError:
        raise ValueError(
            f"unknown collective {name!r}; registered: {sorted(COLLECTIVES)}"
        ) from None


def optical_message_bytes(plan: "CollectivePlan") -> float:
    """Bytes of one schedule item of ``plan`` — the per-step message size
    the optical Eq.-3 model prices AND the size every ``simulate`` call must
    pass: the whole shard for gather traffic, a ``1/n`` (origin,
    destination) block for exchange traffic."""
    return collective_kind(plan.collective).message_bytes(plan.shard_bytes, plan.n)


@dataclass(frozen=True)
class Transfer:
    """One logical block movement: ``src`` sends origin-block ``item`` to
    ``dst``.  ``bytes`` is the block size (the scattered shard d)."""

    src: int
    dst: int
    item: int
    bytes: float


@dataclass(frozen=True)
class Hop:
    """One synchronized communication round within a stage.  A ``oneshot``
    stage has exactly one hop (the all-to-all broadcast); a ``perhop``
    stage has ``factor - 1`` ring hops, each causally after the previous."""

    transfers: Tuple[Transfer, ...]


@dataclass(frozen=True)
class PlanStage:
    """One stage of a staged collective.

    ``payload_bytes`` is the PER-HOP per-device payload the stage moves:
    the entering payload for a gather stage (grows by the already-gathered
    factors), the leaving payload for a scatter stage (shrinks) — exactly
    the ``p`` in the ``(f-1)·(α + p/B)`` barrier and
    ``max((f-1)·p/B + α, (f-1)·α + p/B)`` overlap models.  ``axis`` is the
    mesh axis the engine executes this stage over (None for paper-world
    plans); ``link`` is the transport model pricing it (None for pure
    optical plans).
    """

    factor: int
    mode: str  # "oneshot" | "perhop" | "exchange"
    payload_bytes: float
    axis: Optional[str] = None
    link: Optional[object] = None  # core.planner.LinkSpec (kept untyped: no cycle)
    hops: Tuple[Hop, ...] = ()

    def __post_init__(self):
        if self.mode not in STAGE_MODES:
            raise ValueError(f"stage mode must be one of {STAGE_MODES}, got {self.mode!r}")
        if self.factor < 1:
            raise ValueError("stage factor must be >= 1")
        if self.mode == "exchange" and self.factor != 2:
            raise ValueError(
                f"exchange stages are bidirectional pairwise rounds; factor "
                f"must be 2, got {self.factor}")


@dataclass(frozen=True)
class CollectivePlan:
    """The unified staged-collective plan (see module docstring).

    ``shard_bytes`` is the scattered-end payload — the AG input / RS output
    shard, the paper's item size d.  ``stages`` are in execution order; for
    ``collective == "ar"`` they span the full 2k-stage RS+AG chain.
    """

    collective: str  # a key of COLLECTIVES: "ag" | "rs" | "ar" | "a2a"
    n: int
    shard_bytes: float
    stages: Tuple[PlanStage, ...]
    mode: str = "oneshot"
    num_chunks: int = 1
    meta: Dict = field(default_factory=dict)

    def __post_init__(self):
        kind = collective_kind(self.collective)
        if self.mode not in PLAN_MODES:
            raise ValueError(f"plan mode must be one of {PLAN_MODES}, got {self.mode!r}")
        prod = math.prod(s.factor for s in self.stages)
        expect = kind.expected_factor_product(self.n)
        if prod != expect:
            raise ValueError(
                f"stage factors {tuple(s.factor for s in self.stages)} do not "
                f"cover n={self.n} for collective {self.collective!r}"
            )

    # -- convenience ---------------------------------------------------------
    @property
    def kind(self) -> CollectiveKind:
        """This plan's registry descriptor (stage algebra)."""
        return collective_kind(self.collective)

    @property
    def factors(self) -> Tuple[int, ...]:
        return tuple(s.factor for s in self.stages)

    @property
    def axes(self) -> Tuple[Optional[str], ...]:
        return tuple(s.axis for s in self.stages)

    @property
    def stage_modes(self) -> Tuple[str, ...]:
        return tuple(s.mode for s in self.stages)

    @property
    def is_fallback(self) -> bool:
        """True when planning degraded this collective to the forced
        one-shot plan (``meta["fallback"]`` holds the reason — e.g. an axis
        dead in both ring directions makes every staged order unroutable)."""
        return bool(self.meta.get("fallback"))

    def with_mode(self, mode: str) -> "CollectivePlan":
        """Same plan, different plan-level execution mode (the per-stage hop
        structure is preserved; it takes effect under ``perhop``/``hybrid``).

        The chunked and hybrid wavefronts carry independent chunk
        decisions; a plan built from a ``HopSchedule`` records both in
        ``meta["mode_chunks"]`` and switching into either mode restores the
        matching count — so ``price(plan.with_mode(m))`` reproduces the
        planner's modeled time for every ``m`` with no explicit
        ``with_chunks`` bookkeeping (an explicit ``with_chunks`` afterwards
        still wins).  A wavefront mode whose restored count is 1 normalizes
        like ``with_chunks(1)`` does (chunked → oneshot, hybrid → perhop):
        the label and the execution never disagree."""
        if mode not in PLAN_MODES:
            raise ValueError(f"plan mode must be one of {PLAN_MODES}, got {mode!r}")
        chunks = self.num_chunks
        mode_chunks = self.meta.get("mode_chunks") if self.meta else None
        if mode_chunks and mode in mode_chunks:
            chunks = mode_chunks[mode]
        if chunks == 1:
            mode = {"chunked": "oneshot", "hybrid": "perhop"}.get(mode, mode)
        return dataclasses.replace(self, mode=mode, num_chunks=chunks)

    def with_chunks(self, num_chunks: int) -> "CollectivePlan":
        """Same plan, different chunk count.  A count that collapses to 1
        (e.g. ``fit_chunks`` on a small shard) normalizes a ``chunked``
        plan back to ``oneshot`` and a ``hybrid`` plan back to ``perhop``
        (its one-chunk degenerate: the ring stages with no wavefront) — the
        label and the execution never disagree, and ``price(plan)`` is
        drift-free either way (a one-chunk wavefront prices exactly as the
        barrier / overlapped stage chain)."""
        if num_chunks < 1:
            raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
        mode = self.mode
        if num_chunks == 1:
            mode = {"chunked": "oneshot", "hybrid": "perhop"}.get(mode, mode)
        return dataclasses.replace(self, num_chunks=num_chunks, mode=mode)

    # -- transfer-structure algebra -----------------------------------------
    def gather_tree(self) -> OpTreePlan:
        """The OpTree plan whose subset algebra generates this plan's
        transfers (gather-order factors; RS/AR reuse it by time reversal)."""
        return OpTreePlan(self.n, gather_chain(self)[0] or (1,))


def gather_chain(plan: CollectivePlan) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(factors, stage_modes) of the plan's lowering-equivalent chain.

    Dispatches on the registry descriptor's ``chain``:

    * ``forward`` (ag, a2a) — the stages as executed.
    * ``reversed`` (rs) — the time-reversed mirror: an RS with execution
      factors (f_1..f_k) moves exactly the transfers of the mirrored AG with
      factors (f_k..f_1) run backwards, so hop/step counts are identical.
    * ``two_phase`` (ar) — only each half is a single chain; callers that
      need the full structure handle the two halves explicitly (see
      ``schedule_from_ir``).

    Per-stage hop structure is the EFFECTIVE mode: a stage's ``perhop``
    preference only materializes when the plan-level mode is ``perhop`` or
    ``hybrid`` — under ``oneshot``/``chunked`` every stage runs as a
    blocking collective, exactly as the executor would run it.  Factor-1
    stages carry no transfers and are dropped.
    """
    kind = collective_kind(plan.collective)
    if kind.two_phase:
        raise ValueError(
            f"{plan.collective} spans two chains; lower the halves separately")
    stages = plan.stages
    if kind.chain == "reversed":
        stages = tuple(reversed(stages))
    pairs = [(s.factor, effective_stage_mode(plan, s)) for s in stages
             if s.factor > 1]
    factors = tuple(f for f, _ in pairs)
    modes = tuple(m for _, m in pairs)
    return factors, modes


def effective_stage_mode(plan: CollectivePlan, stage: PlanStage) -> str:
    """The hop structure a stage actually executes/lowers with under the
    plan-level mode (stage ``perhop`` applies only when the plan is
    ``perhop`` or ``hybrid`` — the hybrid wavefront flows over the same
    ring stages the perhop mode runs).  An ``exchange`` stage IS its
    structure under every plan mode: a latency plan's bidirectional
    pairwise round has no alternative hop decomposition."""
    if stage.mode == "exchange":
        return "exchange"
    return stage.mode if plan.mode in ("perhop", "hybrid") else "oneshot"


def _ring_hops(
    tree: OpTreePlan, stage: int, shard_bytes: float
) -> List[Hop]:
    """``m - 1`` double-buffered ring hops for stage ``stage`` (1-indexed).

    Hop t: within every subset (members ascending ring position), the
    member at subset position q forwards to position (q+1) mod m the
    stage-entry items of position (q - t + 1) mod m — the block received at
    hop t-1 (at t=1, its own holding).  After m-1 hops every member has
    every sibling's stage-entry items: the ring all-gather the per-hop
    executor runs (``comms.ring_executor.ring_all_gather_stage``).
    """
    m = tree.factors[stage - 1]
    hops: List[Hop] = []
    subsets = list(tree.subsets(stage))
    entry_items = {
        p: tree.items_to_send(stage, p)
        for sub in subsets
        for p in sub.members
    }
    for t in range(1, m):
        transfers: List[Transfer] = []
        for sub in subsets:
            members = sub.members
            for q, src in enumerate(members):
                dst = members[(q + 1) % m]
                origin = members[(q - t + 1) % m]
                for item in entry_items[origin]:
                    transfers.append(Transfer(src, dst, item, shard_bytes))
        hops.append(Hop(tuple(transfers)))
    return hops


def _oneshot_hop(
    tree: OpTreePlan, stage: int, shard_bytes: float
) -> List[Hop]:
    """The paper's stage: one all-to-all broadcast round per subset — each
    member sends every item it entered the stage with to every sibling."""
    transfers: List[Transfer] = []
    for sub in tree.subsets(stage):
        for src in sub.members:
            items = tree.items_to_send(stage, src)
            for dst in sub.members:
                if dst == src:
                    continue
                for item in items:
                    transfers.append(Transfer(src, dst, item, shard_bytes))
    return [Hop(tuple(transfers))]


def _a2a_stage_transfers(
    tree: OpTreePlan, stage: int, shard_bytes: float
) -> List[Tuple[int, Transfer]]:
    """(digit shift, Transfer) for every block an exchange stage moves.

    Item space is the n² (origin, destination) blocks, labeled
    ``u * n + v`` with each block ``shard_bytes / n``.  At stage-``j`` entry
    block (u, v) resides at the node whose mixed-radix coords are
    ``(v_1..v_{j-1}, u_j..u_k)``; stage j rewrites digit j from ``u_j`` to
    ``v_j`` — after all k stages the block sits at v: the full all-to-all.
    A block with ``u_j == v_j`` does not move; the rest travel within the
    same stage-``j`` subset the gather traffic uses (same groups, 1/m of
    the resident bytes to each sibling — the scaled-payload semantics)."""
    n = tree.n
    block = shard_bytes / n
    j = stage
    m = tree.factors[j - 1]
    out: List[Tuple[int, Transfer]] = []
    coords = [tree.coords(p) for p in range(n)]
    for u in range(n):
        cu = coords[u]
        for v in range(n):
            cv = coords[v]
            if cu[j - 1] == cv[j - 1]:
                continue
            src = tree.node(cv[: j - 1] + cu[j - 1:])
            dst = tree.node(cv[:j] + cu[j:])
            shift = (cv[j - 1] - cu[j - 1]) % m
            out.append((shift, Transfer(src, dst, u * n + v, block)))
    return out


def _a2a_oneshot_hop(
    tree: OpTreePlan, stage: int, shard_bytes: float
) -> List[Hop]:
    """One synchronized exchange round: every member of every stage subset
    sends its 1/m destination slices to all m-1 siblings at once."""
    return [Hop(tuple(t for _, t in _a2a_stage_transfers(tree, stage, shard_bytes)))]


def _a2a_ring_hops(
    tree: OpTreePlan, stage: int, shard_bytes: float
) -> List[Hop]:
    """``m - 1`` rotation hops: hop t carries exactly the slices whose digit
    shift ``(v_j - u_j) mod m == t`` — every block moves once, in the hop
    matching its shift distance, so the union over hops equals the oneshot
    round and hops are causally independent (no forwarding chains: the
    double-buffered overlap model applies)."""
    m = tree.factors[stage - 1]
    buckets: List[List[Transfer]] = [[] for _ in range(m)]
    for shift, t in _a2a_stage_transfers(tree, stage, shard_bytes):
        buckets[shift].append(t)
    return [Hop(tuple(buckets[t])) for t in range(1, m)]


def stage_hops(
    factors: Sequence[int],
    modes: Sequence[str],
    stage_idx: int,
    shard_bytes: float,
    *,
    collective: str = "ag",
) -> List[Hop]:
    """Hops of lowering-chain stage ``stage_idx`` (0-indexed execution
    order), built by the collective's traffic family (gather broadcast
    subsets vs. exchange digit transposes).  An ``exchange`` stage mode
    (factor 2) builds the oneshot hop: a factor-2 all-to-all broadcast
    round IS the bidirectional pairwise exchange."""
    tree = OpTreePlan(int(math.prod(factors)), tuple(factors))
    if modes[stage_idx] == "exchange" and factors[stage_idx] != 2:
        raise ValueError("exchange stage modes require factor 2")
    perhop = modes[stage_idx] == "perhop"
    if collective_kind(collective).traffic == "exchange":
        builder = _a2a_ring_hops if perhop else _a2a_oneshot_hop
    else:
        builder = _ring_hops if perhop else _oneshot_hop
    return builder(tree, stage_idx + 1, shard_bytes)


def expand_hops(plan: CollectivePlan) -> CollectivePlan:
    """Materialize ``hops`` on every stage of a single-chain plan.

    RS stages get the hops of their time-reversed mirror AG (identical
    counts; the executed RS runs them backwards carrying partial sums);
    exchange (a2a) stages get their digit-transpose hops over the n² block
    items.  O(N^2) transfers — validation-sized plans only.
    """
    kind = collective_kind(plan.collective)
    factors, modes = gather_chain(plan)
    per_stage: List[Tuple[Hop, ...]] = []
    for j in range(len(factors)):
        per_stage.append(tuple(stage_hops(
            factors, modes, j, plan.shard_bytes, collective=plan.collective)))
    if kind.chain == "reversed":
        per_stage = list(reversed(per_stage))
    out: List[PlanStage] = []
    it = iter(per_stage)
    for st in plan.stages:
        hops = next(it) if st.factor > 1 else ()
        out.append(dataclasses.replace(st, hops=hops))
    return dataclasses.replace(plan, stages=tuple(out))
