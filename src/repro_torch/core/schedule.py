"""Transmission-level schedules with routing and wavelength assignment (RWA).

A *schedule* is the object the paper's simulator consumes: for every
communication step (time slot), a set of lightpaths
``(direction, wavelength, src, dst, item)``, where a lightpath occupies every
fiber link along its route for the whole step and carries exactly one data
item of size ``d`` (the paper's load-balance rule).

Ring model: ``n`` nodes; clockwise (CW) link ``i`` joins node ``i -> i+1 mod
n``; counter-clockwise (CCW) link ``i`` joins ``i+1 -> i``.  The two
directions are separate fibers (TeraRack has two fiber rings per direction;
we model one per direction and let ``w`` describe its wavelength count, which
matches the paper's step accounting).

Wavelength assignment is greedy first-fit over a conflict structure (two
lightpaths conflict iff they share a directed link); colors are packed into
steps of ``w`` wavelengths: ``step = color // w``, ``wavelength = color % w``.
For line segments first-fit in left-endpoint order is *optimal* (interval
graphs); for rings it is near-optimal and validated against the closed forms
in tests.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .tree import OpTreePlan, mixed_radix_sizes

__all__ = [
    "Tx",
    "Schedule",
    "route_ring",
    "route_line",
    "build_optree_schedule",
    "build_one_stage_schedule",
    "build_ring_schedule",
    "build_ne_schedule",
    "schedule_from_ir",
]

CW, CCW = 0, 1


@dataclass(frozen=True)
class Tx:
    """One scheduled lightpath transmission."""

    step: int
    wavelength: int
    direction: int  # CW | CCW
    src: int
    dst: int
    item: int  # original owner of the data block
    links: Tuple[int, ...]  # link ids occupied (orientation per `direction`)


@dataclass
class Schedule:
    n: int
    w: int
    txs: List[Tx] = field(default_factory=list)
    stage_steps: List[int] = field(default_factory=list)  # steps per stage
    meta: Dict = field(default_factory=dict)

    @property
    def num_steps(self) -> int:
        return 1 + max((t.step for t in self.txs), default=-1)

    def by_step(self) -> List[List[Tx]]:
        out: List[List[Tx]] = [[] for _ in range(self.num_steps)]
        for t in self.txs:
            out[t.step].append(t)
        return out


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------
def route_ring(n: int, s: int, t: int) -> Tuple[int, Tuple[int, ...]]:
    """Shortest-direction route on the full ring (ties balanced by parity)."""
    d_cw = (t - s) % n
    d_ccw = (s - t) % n
    if d_cw < d_ccw or (d_cw == d_ccw and s % 2 == 0):
        return CW, tuple((s + i) % n for i in range(d_cw))
    return CCW, tuple((s - 1 - i) % n for i in range(d_ccw))


def route_line(
    n: int, seg_start: int, seg_len: int, s: int, t: int
) -> Tuple[int, Tuple[int, ...]]:
    """Route within a contiguous ring segment (no wrap-around): stages >= 2.

    Positions are absolute node ids; both must lie inside the segment.
    """
    ps = (s - seg_start) % n
    pt = (t - seg_start) % n
    if not (ps < seg_len and pt < seg_len):
        raise ValueError("endpoints outside segment")
    if pt > ps:  # forward along the segment = CW
        return CW, tuple((s + i) % n for i in range(pt - ps))
    return CCW, tuple((s - 1 - i) % n for i in range(ps - pt))


# --------------------------------------------------------------------------
# Wavelength/step coloring
#
# A "color" is a (step, wavelength) slot: step = color // w, wl = color % w.
# The two fiber directions are independent resources, so a color may be used
# once per direction per link — colors are assigned per direction and the
# stage's step count is ceil(max(colors_cw, colors_ccw) / w).
# --------------------------------------------------------------------------
RawTx = Tuple[int, int, int, int, Tuple[int, ...]]  # (src, dst, item, dir, links)


class _Colorer:
    """Greedy first-fit coloring on per-direction link resources.

    Optimal for line stages when transmissions are processed in
    left-endpoint order (interval-graph coloring)."""

    def __init__(self, n: int, init_colors: int = 64):
        self.n = n
        self.occ = np.zeros((2, n, init_colors), dtype=bool)

    def _grow(self):
        self.occ = np.concatenate([self.occ, np.zeros_like(self.occ)], axis=2)

    def assign(self, direction: int, links: Sequence[int]) -> int:
        if not links:
            return 0  # src == dst (degenerate); never happens in practice
        l = np.fromiter(links, dtype=np.int64)
        while True:
            used = self.occ[direction, l, :].any(axis=0)
            free = np.flatnonzero(~used)
            if free.size:
                c = int(free[0])
                self.occ[direction, l, c] = True
                return c
            self._grow()


def _interval_color(raw: List[RawTx], n: int) -> np.ndarray:
    """Line stages: first-fit in left-endpoint order (optimal per direction)."""
    order = sorted(range(len(raw)), key=lambda i: (min(raw[i][4]), -len(raw[i][4])))
    colorer = _Colorer(n)
    colors = np.empty(len(raw), dtype=np.int64)
    for i in order:
        _, _, _, direction, links = raw[i]
        colors[i] = colorer.assign(direction, links)
    return colors


def _tiling_color(raw: List[RawTx], n: int) -> np.ndarray:
    """Ring stages: partition arcs into non-overlapping ring tilings.

    Each color is built by walking the ring once from a start position,
    greedily placing the longest remaining arc that fits before the walk
    wraps.  Achieves the ceil(m^2/8) clique bound exactly for the paper's
    example sizes and stays within ~1% above it for large m (validated in
    tests); strictly better than plain first-fit on circular arcs.
    """
    colors = np.empty(len(raw), dtype=np.int64)
    for direction in (CW, CCW):
        idxs = [i for i, r in enumerate(raw) if r[3] == direction]
        # arcs keyed by start link; CW arcs run ascending from links[0],
        # CCW arcs run descending from links[0] — normalize to a walk
        # direction by mirroring CCW starts.
        by_start: Dict[int, List[Tuple[int, int]]] = {}
        for i in idxs:
            links = raw[i][4]
            start = links[0] if direction == CW else (n - 1 - links[0]) % n
            by_start.setdefault(start, []).append((len(links), i))
        for v in by_start.values():
            v.sort()  # ascending length; pop from the back for "longest"
        remaining = sum(len(v) for v in by_start.values())
        color = 0
        while remaining:
            start = max(by_start, key=lambda s: len(by_start[s]))
            if not by_start[start]:
                by_start.pop(start)
                continue
            p, used = start, 0
            while used < n:
                room = n - used
                bucket = by_start.get(p)
                placed = False
                if bucket:
                    for bi in range(len(bucket) - 1, -1, -1):
                        if bucket[bi][0] <= room:
                            length, i = bucket.pop(bi)
                            colors[i] = color
                            remaining -= 1
                            p = (p + length) % n
                            used += length
                            placed = True
                            break
                if not placed:
                    p = (p + 1) % n
                    used += 1
            color += 1
    return colors


def _color_stage(
    raw: List[RawTx],
    n: int,
    w: int,
    step_offset: int,
    *,
    ring_mode: bool,
    coalesce: bool = False,
) -> Tuple[List[Tx], int]:
    """Color one synchronized stage; returns (txs, steps_used).

    ``coalesce`` is the exchange-stage (pairwise round) rule: every item
    flowing between one ``(src, dst)`` pair shares a SINGLE lightpath as a
    serialized burst — one color per (src, dst, direction) group instead
    of one per item.  The group's items all land on the same (step,
    wavelength); the step's duration accounting (burst × d in Eq. 3) lives
    in the cost model and simulator, which treat same-pair same-slot
    transmissions as one long transfer rather than a conflict.
    """
    if not raw:
        return [], 0
    if coalesce:
        groups: Dict[Tuple[int, int, int], List[int]] = {}
        for i, r in enumerate(raw):
            groups.setdefault((r[0], r[1], r[3]), []).append(i)
        reps = [raw[v[0]] for v in groups.values()]
        rep_colors = (_tiling_color(reps, n) if ring_mode
                      else _interval_color(reps, n))
        colors = np.empty(len(raw), dtype=np.int64)
        for v, c in zip(groups.values(), rep_colors):
            colors[np.fromiter(v, dtype=np.int64)] = int(c)
    else:
        colors = _tiling_color(raw, n) if ring_mode else _interval_color(raw, n)
    # per-direction color spaces are independent; step count is driven by the
    # busier direction
    ncolors = 0
    for direction in (CW, CCW):
        cs = [int(colors[i]) for i, r in enumerate(raw) if r[3] == direction]
        if cs:
            ncolors = max(ncolors, max(cs) + 1)
    txs = [
        Tx(
            step=step_offset + int(c) // w,
            wavelength=int(c) % w,
            direction=d,
            src=s,
            dst=t,
            item=it,
            links=lk,
        )
        for (s, t, it, d, lk), c in zip(raw, colors)
    ]
    return txs, math.ceil(ncolors / w)


def _one_stage_raw(
    participants: Sequence[int],
    items_of: Callable[[int], Sequence[int]],
    n: int,
    segment: Optional[Tuple[int, int]],
) -> List[Tuple[int, int, int, int, Tuple[int, ...]]]:
    """All-to-all broadcast lightpaths for one subset (one per (src,dst,item))."""
    raw = []
    for s in participants:
        items = items_of(s)
        for t in participants:
            if t == s:
                continue
            if segment is None:
                d, links = route_ring(n, s, t)
            else:
                d, links = route_line(n, segment[0], segment[1], s, t)
            for it in items:
                raw.append((s, t, it, d, links))
    return raw


# --------------------------------------------------------------------------
# Schedule builders
# --------------------------------------------------------------------------
def build_optree_schedule(plan: OpTreePlan, w: int) -> Schedule:
    """The paper's OpTree schedule for a concrete plan (§III-D.1)."""
    sched = Schedule(n=plan.n, w=w, meta={"algorithm": "optree", "factors": plan.factors})
    offset = 0
    for stage in range(1, plan.k + 1):
        raw: List[Tuple[int, int, int, int, Tuple[int, ...]]] = []
        send_cache: Dict[int, Tuple[int, ...]] = {}
        for subset in plan.subsets(stage):
            for s in subset.members:
                if s not in send_cache:
                    send_cache[s] = plan.items_to_send(stage, s)
            raw.extend(
                _one_stage_raw(
                    subset.members, lambda p: send_cache[p], plan.n, subset.segment
                )
            )
        txs, steps = _color_stage(raw, plan.n, w, offset, ring_mode=(stage == 1))
        sched.txs.extend(txs)
        sched.stage_steps.append(steps)
        offset += steps
    return sched


def _lower_gather_chain(
    sched: Schedule,
    factors: Sequence[int],
    modes: Sequence[str],
    w: int,
    offset: int,
    *,
    collective: str = "ag",
) -> int:
    """Lower one stage chain (execution-order ``factors`` with per-stage hop
    ``modes``) into ``sched``, starting at step ``offset``.

    The transfers come straight from ``plan_ir.stage_hops`` — the IR's own
    hop expansion is the single source of truth; this function only adds
    routing and RWA coloring.  The IR places participants in
    execution-major mixed-radix ring order, so stage-1 transfers route on
    the whole ring and stage-j>=2 transfers inside their contiguous parent
    segment of size ``prod(factors[j-1:])`` — exactly like
    ``build_optree_schedule``.  This holds for exchange (a2a) traffic too:
    a digit-transpose stage moves blocks only within the same stage-j
    subsets the gather broadcast uses, so the identical routing geometry
    applies (the items are the n² (origin, destination) blocks instead of
    the n origin shards).  A ``oneshot`` stage is one synchronized round; a
    ``perhop`` stage is ``m-1`` causally ordered hops, each colored into
    its own step block; an ``exchange`` stage (factor-2 pairwise round) is
    one synchronized round with BURST coalescing — each pair's items share
    one lightpath.  Returns the new step offset; appends one
    ``stage_steps`` entry per stage.
    """
    from .plan_ir import stage_hops  # local import: avoid a cycle
    from .tree import mixed_radix_sizes

    n = math.prod(factors)
    child_sizes = mixed_radix_sizes(factors)
    for j, (m, mode) in enumerate(zip(factors, modes)):
        parent_sz = child_sizes[j] * m
        stage_steps = 0
        for hop in stage_hops(factors, modes, j, 0.0, collective=collective):
            raw: List[RawTx] = []
            for t in hop.transfers:
                if j == 0:
                    d, links = route_ring(n, t.src, t.dst)
                else:
                    seg_start = (t.src // parent_sz) * parent_sz
                    d, links = route_line(n, seg_start, parent_sz, t.src, t.dst)
                raw.append((t.src, t.dst, t.item, d, links))
            txs, steps = _color_stage(raw, n, w, offset, ring_mode=(j == 0),
                                      coalesce=(mode == "exchange"))
            sched.txs.extend(txs)
            offset += steps
            stage_steps += steps
        sched.stage_steps.append(stage_steps)
    return offset


def schedule_from_ir(plan, w: int, *, health=None) -> Schedule:
    """Lower a :class:`~repro_torch.core.plan_ir.CollectivePlan` to a Tx-level
    :class:`Schedule` the optical simulator can execute and conflict-check.

    ``health`` (a :class:`~repro_torch.core.health.LinkHealth`) restricts the RWA
    to the *healthy* wavelengths: the lost set is the union of the plan
    axes' lost-wavelength masks (the WDM ring is a shared medium), the
    coloring runs with the shrunken effective ``w``, and the color slots are
    then remapped onto the surviving wavelength indices — an injective
    remap, so conflict-freedom is preserved and no transmission ever lands
    on a failed wavelength.  ``num_steps`` grows accordingly, which is
    exactly how lost wavelengths surface in the Eq.-3 price
    (``price(plan, system, health=...)`` uses this same lowering).

    * ``ag`` — lowered directly: the plan's execution-order stages become
      OpTree stages (oneshot = all-to-all broadcast round, perhop = m-1 ring
      hops).  For an all-oneshot plan this reproduces
      ``build_optree_schedule(OpTreePlan(n, factors), w)`` transmission for
      transmission.
    * ``rs`` — lowered as the time-reversed mirror all-gather (reversed
      stage order): a reduce-scatter runs exactly those lightpaths backwards
      carrying partial sums, so step and transmission counts are identical
      (the duality ``optics/comparison.py`` prices).  Items flow in gather
      direction so the simulator's causality/completeness checks apply.
      ``stage_steps`` is re-reversed to the plan's EXECUTION order, so
      per-stage attribution (``SimReport.stage_times_s``,
      ``PriceReport.stage_times_s``) pairs with ``plan.factors`` — stage i
      of the plan occupies the time-reversed i-th block of the schedule.
    * ``ar`` — the RS mirror chain followed by the AG chain (2k stages);
      the RS half's ``stage_steps`` are execution-ordered the same way.
    * ``a2a`` — lowered forward like ``ag`` but with exchange traffic: the
      items are the n² (origin, destination) blocks (labels ``u·n + v``,
      each ``shard/n`` bytes) and stage j transposes one mixed-radix digit
      within the same subsets/segments the gather stages use.
      ``meta["semantics"] = "exchange"`` tells the simulator to start node
      u holding ``{u·n + v}`` and check node v ends holding ``{u·n + v}``.

    Chunking (``plan.mode == "chunked"``) is an executor-side wavefront over
    whole-stage collectives; the optical step structure is unchanged, so the
    lowering ignores ``num_chunks``.  The ``hybrid`` mode (chunk wavefront
    OVER per-hop ring stages) lowers like ``perhop`` — each ring-preference
    stage becomes its m-1 causally ordered hop step blocks
    (``effective_stage_mode`` materializes stage ``perhop`` under both plan
    modes) and the wavefront stays executor-side, so
    ``price(plan, OpticalSystem)`` for a hybrid plan equals the simulator's
    wall time on this lowering exactly as for every other mode.
    """
    from .plan_ir import collective_kind, effective_stage_mode  # local import: avoid a cycle

    lost: frozenset = frozenset()
    if health is not None:
        lost = frozenset(wl for wl in health.lost_for(plan.axes) if wl < w)
    healthy_slots = [wl for wl in range(w) if wl not in lost]
    if not healthy_slots:
        from .health import HealthError  # local import: avoid a cycle
        raise HealthError(
            f"all {w} wavelengths lost for axes {plan.axes}: "
            "no healthy wavelength to schedule on")
    w_eff = len(healthy_slots)
    kind = collective_kind(plan.collective)
    sched = Schedule(
        n=plan.n, w=w_eff,
        meta={"algorithm": f"ir-{plan.collective}",
              "factors": plan.factors,
              "modes": plan.stage_modes,
              "mode": plan.mode,
              "semantics": kind.traffic,
              "axes": plan.axes,
              "source": plan.meta.get("source")},
    )
    # factor-1 stages are lowered too (zero transfers, zero steps) so
    # ``stage_steps`` always has one entry per plan stage and per-stage
    # attribution pairs with ``plan.factors`` index for index
    offset = 0
    if kind.two_phase:
        k = len(plan.stages) // 2
        halves = ((plan.stages[:k], True), (plan.stages[k:], False))
    else:
        halves = ((plan.stages, kind.chain == "reversed"),)
    stage_ranges: List[Tuple[int, int]] = []
    stage_circuits: List[Tuple] = []
    for half, flip in halves:
        # scatter halves lower as their time-reversed mirror all-gather
        stages = tuple(reversed(half)) if flip else half
        if not stages:
            continue
        mark = len(sched.stage_steps)
        start = offset
        factors = [s.factor for s in stages]
        offset = _lower_gather_chain(
            sched,
            factors,
            [effective_stage_mode(plan, s) for s in stages],
            w_eff, offset,
            collective=plan.collective,
        )
        # (start_step, n_steps) per lowered stage of this half, so pricing
        # can attribute per-step times to stages even when steps within a
        # stage differ in duration (exchange bursts)
        ranges: List[Tuple[int, int]] = []
        for steps in sched.stage_steps[mark:]:
            ranges.append((start, steps))
            start += steps
        # circuit signature per lowered stage — the lightpath layout the
        # photonic fabric must be configured for: the whole ring for the
        # first chain stage, contiguous parent segments of shrinking size
        # for deeper stages (mirrors _lower_gather_chain's routing).  A
        # boundary between differing signatures is a circuit
        # reconfiguration event in the Eq.-3 accounting.
        child_sizes = mixed_radix_sizes(factors)
        circuits: List[Tuple] = [
            ("ring", plan.n) if j == 0
            else ("line", child_sizes[j] * m)
            for j, m in enumerate(factors)
        ]
        if flip:  # attribution back to execution order
            sched.stage_steps[mark:] = sched.stage_steps[mark:][::-1]
            ranges.reverse()
            circuits.reverse()
        stage_ranges.extend(ranges)
        stage_circuits.extend(circuits)
    sched.meta["stage_ranges"] = tuple(stage_ranges)
    sched.meta["circuits"] = tuple(stage_circuits)
    if lost:
        # remap color slots 0..w_eff-1 onto the surviving wavelength
        # indices (injective, so the conflict structure is untouched) and
        # restore the physical ring width for range checks / telemetry
        sched.txs[:] = [
            dataclasses.replace(tx, wavelength=healthy_slots[tx.wavelength])
            for tx in sched.txs
        ]
        sched.w = w
        sched.meta["lost_wavelengths"] = tuple(sorted(lost))
        sched.meta["w_effective"] = w_eff
    return sched


def build_one_stage_schedule(n: int, w: int) -> Schedule:
    """One-stage model: direct all-to-all broadcast on the ring (k=1)."""
    sched = Schedule(n=n, w=w, meta={"algorithm": "one-stage"})
    raw = _one_stage_raw(list(range(n)), lambda p: (p,), n, None)
    txs, steps = _color_stage(raw, n, w, 0, ring_mode=True)
    sched.txs.extend(txs)
    sched.stage_steps.append(steps)
    return sched


def build_ring_schedule(n: int, w: int) -> Schedule:
    """Classic ring all-gather: step t, node i forwards item (i - t) mod n CW."""
    sched = Schedule(n=n, w=w, meta={"algorithm": "ring"})
    for step in range(n - 1):
        for i in range(n):
            item = (i - step) % n
            sched.txs.append(
                Tx(step=step, wavelength=0, direction=CW, src=i,
                   dst=(i + 1) % n, item=item, links=(i,))
            )
    sched.stage_steps = [n - 1]
    return sched


def build_ne_schedule(n: int, w: int) -> Schedule:
    """Neighbor-Exchange all-gather (Chen et al. 2005): N/2 steps, n even.

    Step 1: even pairs (2i, 2i+1) swap their own items.  Step t>=2: pairing
    parity alternates and each node forwards the two items it received in
    step t-1.
    """
    if n % 2:
        raise ValueError("neighbor-exchange needs even n")
    sched = Schedule(n=n, w=w, meta={"algorithm": "neighbor-exchange"})
    last_recv: List[List[int]] = [[i] for i in range(n)]
    for step in range(n // 2):
        pairs = (
            [((2 * i) % n, (2 * i + 1) % n) for i in range(n // 2)]
            if step % 2 == 0
            else [((2 * i + 1) % n, (2 * i + 2) % n) for i in range(n // 2)]
        )
        new_recv: List[List[int]] = [[] for _ in range(n)]
        for a, b in pairs:
            link_cw, link_ccw = a, a  # link between a and b=(a+1)%n
            for wl, item in enumerate(last_recv[a]):
                sched.txs.append(Tx(step=step, wavelength=wl, direction=CW,
                                    src=a, dst=b, item=item, links=(link_cw,)))
                new_recv[b].append(item)
            for wl, item in enumerate(last_recv[b]):
                sched.txs.append(Tx(step=step, wavelength=wl, direction=CCW,
                                    src=b, dst=a, item=item, links=(link_ccw,)))
                new_recv[a].append(item)
        if step == 0:
            # after the first exchange each node forwards the pair
            # {own item, partner's item}, not just the single receipt
            last_recv = [[i] + new_recv[i] for i in range(n)]
        else:
            last_recv = new_recv
    sched.stage_steps = [n // 2]
    return sched
