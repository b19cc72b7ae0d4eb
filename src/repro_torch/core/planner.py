"""Generalized Theorem 2: stage planning for TPU mesh collectives.

The paper minimizes  S(k) = ceil((2k-1) N^{1+1/k} / 8w)  over the tree depth
k — trading per-stage channel demand against stage count.  On a TPU mesh the
"channel" is a torus-axis link and the analogue is:

    T(m_1..m_k; order) = sum_j (m_j - 1) * (alpha_j + payload_j / B_j)
    payload_j          = shard_bytes * prod_{i<j} m_i

i.e. each stage is a ring all-gather over m_j participants whose per-hop
payload has grown by the factors already gathered.  Total moved volume is
invariant (telescopes to (N-1)*shard); what the plan controls is
  * the latency term   sum_j (m_j - 1) * alpha_j   (Thm 2's trade-off), and
  * *which axis carries which payload* — on heterogeneous axes
    (pod/DCN vs. ICI) gathering the slow axis first moves the un-multiplied
    payload over the slow links: the direct analogue of OpTree's stage-1
    strided subsets running while each node holds a single item.

``plan_staged_allgather`` covers the homogeneous single-axis case (factorize
an axis, pick k) and the heterogeneous multi-axis case (order given axes).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .cost_model import TERARACK
from .plan_ir import collective_kind
from .tree import balanced_factors

__all__ = ["LinkSpec", "StagePlan", "AllGatherPlan", "AllReducePlan",
           "HopSchedule", "FusedMatmulPlan", "load_links",
           "plan_staged_allgather", "plan_axis_order",
           "plan_reduce_scatter_order", "plan_all_reduce",
           "pipeline_makespan", "choose_num_chunks",
           "perhop_stage_time", "choose_hop_schedule",
           "plan_latency_collective", "latency_crossover_bytes",
           "OrderCandidate", "OrderSearch", "search_stage_orders",
           "plan_collective_matmul", "matmul_block_time",
           "ICI_LINK", "DCN_LINK", "MXU_PEAK_FLOPS"]


@dataclass(frozen=True)
class LinkSpec:
    """Per-stage transport characteristics."""

    name: str
    bandwidth_bytes: float  # per-device injection bandwidth over this link
    alpha_s: float  # fixed per-hop cost (launch + hop latency)

    def to_json(self) -> dict:
        return {"name": self.name, "bandwidth_bytes": self.bandwidth_bytes,
                "alpha_s": self.alpha_s}

    @staticmethod
    def from_json(d: dict, fallback: Optional["LinkSpec"] = None) -> "LinkSpec":
        """Build a LinkSpec from a dict — the ``to_json`` form or one entry
        of ``launch/perf.py --calibrate``'s ``fitted_links`` output.

        A calibration sweep on alpha-dominated transport reports
        ``bandwidth_bytes: null`` (unidentifiable); those fall back to
        ``fallback`` (or the entry's own ``hardcoded`` record) so a fitted
        file always round-trips into a usable spec.
        """
        bw = d.get("bandwidth_bytes")
        alpha = d.get("alpha_s")
        hard = d.get("hardcoded") or {}
        if bw is None:
            bw = (fallback.bandwidth_bytes if fallback is not None
                  else hard.get("bandwidth_bytes"))
        if alpha is None:
            alpha = (fallback.alpha_s if fallback is not None
                     else hard.get("alpha_s"))
        if bw is None or alpha is None:
            raise ValueError(f"cannot build LinkSpec from {d!r}: missing "
                             f"bandwidth/alpha and no fallback")
        bw, alpha = float(bw), float(alpha)
        if bw <= 0.0 or alpha < 0.0:
            raise ValueError(
                f"invalid LinkSpec values in {d!r}: bandwidth_bytes must be "
                f"> 0 (got {bw}) and alpha_s >= 0 (got {alpha})")
        return LinkSpec(name=str(d.get("name", "link")),
                        bandwidth_bytes=bw, alpha_s=alpha)


def load_links(
    path,
    fallbacks: Optional[dict] = None,
    *,
    expect_axes: Optional[Sequence[str]] = None,
    allow_missing: bool = False,
) -> dict:
    """Load an axis-name -> LinkSpec map from a JSON file.

    Accepts either a plain ``{axis: LinkSpec.to_json()}`` map or the full
    ``launch/perf.py --calibrate`` output (``{"fitted_links": {...}}``) —
    the calibration loop's feedback path into the comms context
    (``comms.api.CommContext.update_links``) / engine ``links=``.

    ``expect_axes`` validates the file against a mesh's axis set instead of
    silently ignoring typos: entries for axes NOT in ``expect_axes`` raise
    ``ValueError`` naming them, and (unless ``allow_missing``, for callers
    that merge onto a default table) so do expected axes the file lacks.
    """
    import json
    from pathlib import Path

    doc = json.loads(Path(path).read_text())
    entries = doc.get("fitted_links", doc)
    if expect_axes is not None:
        expect = set(expect_axes)
        unknown = sorted(set(entries) - expect)
        missing = sorted(expect - set(entries))
        if unknown or (missing and not allow_missing):
            raise ValueError(
                f"links file {path} does not match axes {sorted(expect)}: "
                f"unknown axes {unknown}, missing axes {missing}")
    out = {}
    for axis, d in entries.items():
        fb = (fallbacks or {}).get(axis)
        out[axis] = LinkSpec.from_json(d, fallback=fb)
    return out


# TPU v5e-flavoured defaults (see roofline constants in launch/roofline.py):
ICI_LINK = LinkSpec("ici", 50e9, 1e-6)
DCN_LINK = LinkSpec("dcn", 6.25e9, 1e-5)  # ~50 Gbit/s/host-link class transport

MXU_PEAK_FLOPS = 197e12  # v5e bf16 peak (launch/roofline.py HW model)


@dataclass(frozen=True)
class StagePlan:
    factor: int
    link: LinkSpec
    payload_bytes: float  # per-device payload entering this stage
    time_s: float


@dataclass(frozen=True)
class AllGatherPlan:
    """A staged collective plan (all-gather or its reduce-scatter dual).

    ``num_chunks`` / ``pipelined_time_s`` carry the chunking decision: split
    the shard into C chunks and software-pipeline stage j of chunk i with
    stage j+1 of chunk i-1.  C=1 means chunking does not pay (alpha-bound).
    """

    stages: Tuple[StagePlan, ...]
    total_time_s: float
    num_chunks: int = 1
    pipelined_time_s: Optional[float] = None

    @property
    def factors(self) -> Tuple[int, ...]:
        return tuple(s.factor for s in self.stages)


@dataclass(frozen=True)
class AllReducePlan:
    """Staged all-reduce = reduce-scatter + all-gather sharing one axis plan
    (AG stage order is the exact reverse of the RS order).

    ``num_chunks``/``pipelined_time_s`` model what ``staged_all_reduce``
    actually executes: ONE 2k-stage RS+AG pipeline with a single shared
    chunk count, not two independently chunked halves.
    """

    reduce_scatter: AllGatherPlan
    all_gather: AllGatherPlan
    num_chunks: int = 1
    pipelined_time_s: Optional[float] = None

    @property
    def total_time_s(self) -> float:
        return self.reduce_scatter.total_time_s + self.all_gather.total_time_s


def _stage_time(factor: int, payload: float, link: LinkSpec) -> float:
    # ring all-gather over `factor` participants: factor-1 hops, each moving
    # the current accumulated payload.
    return (factor - 1) * (link.alpha_s + payload / link.bandwidth_bytes)


def _plan_from_law(
    collective: str, factors: Sequence[int], links: Sequence[LinkSpec],
    shard_bytes: float,
) -> AllGatherPlan:
    """Stage chain priced by the registry's payload-per-stage law
    (``plan_ir.CollectiveKind.stage_payloads``): gather grows, scatter
    shrinks, exchange moves a constant ``shard / f_j`` per peer."""
    payloads = collective_kind(collective).stage_payloads(shard_bytes, factors)
    stages = tuple(
        StagePlan(factor=f, link=link, payload_bytes=p,
                  time_s=_stage_time(f, p, link))
        for f, link, p in zip(factors, links, payloads)
    )
    return AllGatherPlan(stages=stages,
                         total_time_s=sum(s.time_s for s in stages))


def _plan_for_factors(
    factors: Sequence[int], links: Sequence[LinkSpec], shard_bytes: float
) -> AllGatherPlan:
    return _plan_from_law("ag", factors, links, shard_bytes)


def plan_staged_allgather(
    axis_size: int,
    shard_bytes: float,
    link: LinkSpec = ICI_LINK,
    max_k: Optional[int] = None,
) -> AllGatherPlan:
    """Homogeneous case: factorize one device axis into the time-optimal
    k-stage plan (generalized Thm 2: integer argmin instead of the continuous
    closed form).
    """
    if axis_size < 1:
        raise ValueError("axis_size >= 1")
    kmax = max_k or max(1, math.ceil(math.log2(max(axis_size, 2))))
    best: Optional[AllGatherPlan] = None
    for k in range(1, kmax + 1):
        factors = balanced_factors(axis_size, k)
        for perm in set(itertools.permutations(factors)):
            plan = _plan_for_factors(perm, [link] * len(perm), shard_bytes)
            if best is None or plan.total_time_s < best.total_time_s:
                best = plan
    assert best is not None
    return best


def _rs_plan_for_factors(
    factors: Sequence[int], links: Sequence[LinkSpec], shard_bytes: float
) -> AllGatherPlan:
    """Reduce-scatter dual: payload *shrinks* stage by stage.  A ring
    reduce-scatter over ``f`` participants with input payload P makes f-1
    hops each moving P/f, leaving P/f per device.  ``shard_bytes`` is the
    *output* shard (input = shard * prod(factors)) so the duality with the
    all-gather plan is literal: reversed factors give mirrored stage costs.
    """
    return _plan_from_law("rs", factors, links, shard_bytes)


def _chunked_stage_times(
    factors: Sequence[int],
    links: Sequence[LinkSpec],
    shard_bytes: float,
    num_chunks: int,
    collective: str,
) -> List[float]:
    """Per-chunk stage times with the shard split into ``num_chunks``:
    bandwidth terms shrink by C, alpha terms are paid per chunk per stage."""
    plan = _plan_from_law(collective, factors, links, shard_bytes / num_chunks)
    return [s.time_s for s in plan.stages]


def pipeline_makespan(stage_times: Sequence[float], num_chunks: int) -> float:
    """Makespan of C chunks flowing through a linear k-stage pipeline where
    each stage is a serially-reused link: fill the pipe once, then the
    slowest stage paces the remaining C-1 chunks."""
    return sum(stage_times) + (num_chunks - 1) * max(stage_times)


# small-message chunking floor (in packets): a shard below this many packets
# is latency-regime traffic — the chunk wavefront's extra per-chunk alphas
# can never be repaid by pipelining bandwidth that small, and the packet-
# quantized wire would not deliver the modeled sub-packet wins anyway.
# ``_best_chunks`` clamps straight to C=1 below ``packet_bytes * FLOOR``.
SMALL_MESSAGE_FLOOR_PACKETS = 32


def _best_chunks(
    times_for_c, max_chunks: int, *, shard_bytes: Optional[float] = None,
    packet_bytes: int = TERARACK.packet_bytes,
) -> Tuple[int, float]:
    """Scan power-of-two chunk counts, minimizing the pipelined makespan of
    whatever stage chain ``times_for_c(c)`` describes.

    Shards under the small-message floor (``packet_bytes *
    SMALL_MESSAGE_FLOOR_PACKETS``) clamp to C=1 outright: KiB-scale
    payloads never pay chunk-wavefront overhead.  Above the floor, chunk
    counts whose per-chunk payload would drop below one packet
    (``packet_bytes``) are never considered: below that the linear d/B model
    is a lie — transfers are packet-quantized, so the modeled win would not
    materialize and chunking can only add launch overhead.  C=1 is always a
    candidate, so the returned makespan never exceeds the unchunked time.
    """
    if (shard_bytes is not None
            and shard_bytes < packet_bytes * SMALL_MESSAGE_FLOOR_PACKETS):
        return 1, pipeline_makespan(times_for_c(1), 1)
    best_c, best_t = 1, math.inf
    c = 1
    while c <= max_chunks:
        if c > 1 and shard_bytes is not None and shard_bytes / c < packet_bytes:
            break  # payload per chunk under one packet; larger C only worse
        t = pipeline_makespan(times_for_c(c), c)
        if t < best_t:
            best_c, best_t = c, t
        c *= 2
    return best_c, best_t


def choose_num_chunks(
    factors: Sequence[int],
    links: Sequence[LinkSpec],
    shard_bytes: float,
    *,
    max_chunks: int = 8,
    collective: str = "ag",
    packet_bytes: int = TERARACK.packet_bytes,
) -> Tuple[int, float]:
    """Pick C minimizing the pipelined makespan (alpha/bandwidth trade-off:
    chunking amortizes bandwidth across stages but multiplies alpha).  C is
    clamped so one chunk never carries less than ``packet_bytes``."""
    return _best_chunks(
        lambda c: _chunked_stage_times(factors, links, shard_bytes, c, collective),
        max_chunks,
        shard_bytes=shard_bytes,
        packet_bytes=packet_bytes,
    )


def _best_permutation(
    axes: Sequence[Tuple[int, LinkSpec]], shard_bytes: float, builder
) -> AllGatherPlan:
    best: Optional[AllGatherPlan] = None
    for perm in itertools.permutations(axes):
        plan = builder([a[0] for a in perm], [a[1] for a in perm], shard_bytes)
        if best is None or plan.total_time_s < best.total_time_s:
            best = plan
    assert best is not None
    return best


def _with_chunking(
    plan: AllGatherPlan, shard_bytes: float, max_chunks: int, collective: str
) -> AllGatherPlan:
    links = [s.link for s in plan.stages]
    c, t = choose_num_chunks(
        plan.factors, links, shard_bytes, max_chunks=max_chunks,
        collective=collective,
    )
    return dataclasses.replace(plan, num_chunks=c, pipelined_time_s=t)


def plan_axis_order(
    axes: Sequence[Tuple[int, LinkSpec]],
    shard_bytes: float,
    *,
    max_chunks: int = 8,
) -> AllGatherPlan:
    """Heterogeneous case: given physical mesh axes (size, link), choose the
    stage *order*.  Provably: sort by ascending bandwidth (slow first) when
    alphas are equal; we brute-force the permutation (k is tiny) so latency
    asymmetries are honoured too.  The returned plan also carries the
    chunking decision (``num_chunks``/``pipelined_time_s``).
    """
    best = _best_permutation(axes, shard_bytes, _plan_for_factors)
    return _with_chunking(best, shard_bytes, max_chunks, "ag")


def plan_reduce_scatter_order(
    axes: Sequence[Tuple[int, LinkSpec]],
    shard_bytes: float,
    *,
    max_chunks: int = 8,
) -> AllGatherPlan:
    """Stage order for the reduce-scatter dual.  ``shard_bytes`` is the
    *output* shard per device (same parameterization as the all-gather
    planner's input shard, so rs.total == ag.total for mirrored orders).

    The optimum is the exact reverse of the all-gather order: the payload
    shrinks stage by stage, so the slow links run *last*, when the payload
    is smallest.
    """
    best = _best_permutation(axes, shard_bytes, _rs_plan_for_factors)
    return _with_chunking(best, shard_bytes, max_chunks, "rs")


def plan_all_reduce(
    axes: Sequence[Tuple[int, LinkSpec]],
    shard_bytes: float,
    *,
    max_chunks: int = 8,
) -> AllReducePlan:
    """Staged all-reduce = RS then AG over one shared axis plan: the AG
    stage order is the exact reverse of the planned RS order (duality), not
    a second independent optimization.  ``shard_bytes`` is the scattered
    (1/N) shard — the payload at the RS/AG boundary.

    The chunk decision is made over the *combined* 2k-stage chain with one
    shared C — matching ``staged_all_reduce``'s wavefront, which flows each
    chunk through RS then AG as a single pipeline.
    """
    rs = plan_reduce_scatter_order(axes, shard_bytes, max_chunks=1)
    ag_factors = [s.factor for s in reversed(rs.stages)]
    ag_links = [s.link for s in reversed(rs.stages)]
    ag = _plan_for_factors(ag_factors, ag_links, shard_bytes)

    rs_links = [s.link for s in rs.stages]
    best_c, best_t = _best_chunks(
        lambda c: (
            _chunked_stage_times(rs.factors, rs_links, shard_bytes, c, "rs")
            + _chunked_stage_times(ag_factors, ag_links, shard_bytes, c, "ag")
        ),
        max_chunks,
        shard_bytes=shard_bytes,
    )
    return AllReducePlan(
        reduce_scatter=rs, all_gather=ag, num_chunks=best_c,
        pipelined_time_s=best_t,
    )


# --------------------------------------------------------------------------
# per-hop overlapped execution (double-buffered ppermute rings)
# --------------------------------------------------------------------------

def perhop_stage_time(factor: int, payload: float, link: LinkSpec) -> float:
    """Exposed time of a double-buffered ring stage over ``factor``
    participants with per-hop payload ``payload``.

    The ring executor forwards the block received at hop t while its local
    copy/reduce (and the next hop's launch) run concurrently, so per hop only
    the longer of {serialization chain, launch chain} is exposed:

        T = max((f-1)·p/B + α,  (f-1)·α + p/B)

    This is the TPU-mesh analogue of ``cost_model.eq3_overlap_time`` — α is
    amortized across in-flight hops when the stage is bandwidth-bound.  The
    barrier model ``_stage_time`` = (f-1)·(α + p/B) is its upper bound.
    """
    if factor <= 1:
        return 0.0
    hops = factor - 1
    serial = payload / link.bandwidth_bytes
    return max(hops * serial + link.alpha_s, hops * link.alpha_s + serial)


def _stage_exposure(factor: int, payload: float, link: LinkSpec) -> Tuple[float, float]:
    """(exposed, hidden) bytes for one overlapped ring stage (see
    ``cost_model.exposed_hidden_bytes``): bandwidth-bound stages expose every
    moved byte and hide the αs; latency-bound stages hide all but one hop's
    payload under the α chain."""
    if factor <= 1:
        return 0.0, 0.0
    moved = (factor - 1) * payload
    if payload / link.bandwidth_bytes >= link.alpha_s:
        return float(moved), 0.0
    return float(payload), float(moved - payload)


@dataclass(frozen=True)
class HopSchedule:
    """Planner decision for HOW a staged collective executes.

      * ``oneshot``  — one blocking XLA collective per stage (PR-1 engine);
      * ``chunked``  — C-chunk wavefront over whole-stage collectives;
      * ``perhop``   — double-buffered ppermute rings (comms/ring_executor),
                       per-stage selectable via ``stage_modes`` ("ring" where
                       the overlap model wins, "oneshot" where a stage is too
                       small for hop pipelining to matter, e.g. factor 2);
      * ``hybrid``   — the chunk wavefront OVER the per-hop ring stages:
                       ``hybrid_chunks`` chunks pipeline through the same
                       ``stage_modes`` chain, each stage costing the overlap
                       max-form (ring) or barrier (oneshot) on a 1/C chunk.
                       Elementwise ≤ the chunked stage times and equal to
                       perhop at C=1, so it is never modeled worse than
                       either pure mode; ties prefer the simpler modes.

    All four modeled times come from the same ``LinkSpec``s;
    ``stage_exposed_bytes``/``stage_hidden_bytes`` carry the per-stage
    exposed-vs-hidden byte accounting of the per-hop mode.
    """

    mode: str
    stage_modes: Tuple[str, ...]
    num_chunks: int
    oneshot_time_s: float
    chunked_time_s: float
    perhop_time_s: float
    stage_exposed_bytes: Tuple[float, ...]
    stage_hidden_bytes: Tuple[float, ...]
    # the priced stage chain (for "ar": the full 2k-stage RS+AG sequence),
    # carried so the schedule lowers losslessly into the CollectivePlan IR
    stages: Tuple[StagePlan, ...] = ()
    collective: str = "ag"
    shard_bytes: float = 0.0
    hybrid_time_s: float = math.inf
    hybrid_chunks: int = 1

    @property
    def time_s(self) -> float:
        return {"oneshot": self.oneshot_time_s, "chunked": self.chunked_time_s,
                "perhop": self.perhop_time_s,
                "hybrid": self.hybrid_time_s}[self.mode]

    @property
    def exposed_bytes(self) -> float:
        return sum(self.stage_exposed_bytes)

    @property
    def hidden_bytes(self) -> float:
        return sum(self.stage_hidden_bytes)

    def to_ir(self, axis_names: Optional[Sequence[str]] = None, *,
              mode: Optional[str] = None):
        """Lower this planner decision into the unified CollectivePlan IR.

        ``axis_names`` labels each stage with the mesh axis the engine
        executes it over (execution order — for ``ar`` the 2k-long RS+AG
        name sequence).  Per-stage hop structure maps ``"ring"`` →
        ``"perhop"``; the plan-level ``mode`` (overridable) selects which
        modeled execution the plan carries — a ``hybrid`` plan carries the
        hybrid wavefront's own chunk count, every other mode the chunked
        decision.
        """
        from .plan_ir import CollectivePlan, PlanStage  # local: avoid a cycle

        if not self.stages:
            raise ValueError("HopSchedule built without its stage chain "
                             "cannot lower to IR")
        names: Sequence[Optional[str]]
        names = tuple(axis_names) if axis_names is not None else (None,) * len(self.stages)
        if len(names) != len(self.stages):
            raise ValueError(
                f"axis_names must have {len(self.stages)} entries, got {names}"
            )
        ir_stages = tuple(
            PlanStage(
                factor=s.factor,
                mode="perhop" if m == "ring" else "oneshot",
                payload_bytes=s.payload_bytes,  # per-hop payload, both duals
                axis=name,
                link=s.link,
            )
            for s, m, name in zip(self.stages, self.stage_modes, names)
        )
        n = math.prod(
            s.factor for s in (self.stages[: len(self.stages) // 2]
                               if collective_kind(self.collective).two_phase
                               else self.stages)
        )
        eff_mode = mode or self.mode
        return CollectivePlan(
            collective=self.collective,
            n=n,
            shard_bytes=self.shard_bytes,
            stages=ir_stages,
            mode=eff_mode,
            num_chunks=(self.hybrid_chunks if eff_mode == "hybrid"
                        else self.num_chunks),
            meta={"source": "hop_schedule",
                  "modeled": {"oneshot": self.oneshot_time_s,
                              "chunked": self.chunked_time_s,
                              "perhop": self.perhop_time_s,
                              "hybrid": self.hybrid_time_s},
                  # per-mode chunk decisions: with_mode restores the right
                  # count when flipping between chunked and hybrid
                  "mode_chunks": {"chunked": self.num_chunks,
                                  "hybrid": self.hybrid_chunks}},
        )


def _stage_chain(
    factors: Sequence[int], links: Sequence[LinkSpec], shard_bytes: float,
    collective: str,
) -> List[StagePlan]:
    """The (factor, link, payload) chain a collective actually executes —
    the registry's payload-per-stage law over the execution order.  For a
    two-phase kind (AR) ``factors`` is the first (RS) half's order and the
    second half mirrors it; single-chain kinds (AG/RS/A2A) execute the
    given order directly."""
    if collective_kind(collective).two_phase:
        rs = _rs_plan_for_factors(factors, links, shard_bytes).stages
        ag = _plan_for_factors(
            [s.factor for s in reversed(rs)], [s.link for s in reversed(rs)],
            shard_bytes,
        ).stages
        return list(rs) + list(ag)
    return list(_plan_from_law(collective, factors, links, shard_bytes).stages)


def choose_hop_schedule(
    factors: Sequence[int],
    links: Sequence[LinkSpec],
    shard_bytes: float,
    *,
    max_chunks: int = 8,
    collective: str = "ag",
    packet_bytes: int = TERARACK.packet_bytes,
    health=None,
    axis_names: Optional[Sequence[Optional[str]]] = None,
) -> HopSchedule:
    """Pick one-shot vs chunked-wavefront vs per-hop vs hybrid execution
    for a staged collective, all from the same ``LinkSpec``s.

    ``health`` (with ``axis_names`` naming each stage's mesh axis) plans
    under the DEGRADED world: every stage link's bandwidth is scaled by its
    axis's best alive direction before any mode decision, so the chosen
    mode/chunking is the one that wins on the hardware as it actually is.
    An axis dead in both directions raises
    :class:`~repro_torch.core.health.DeadAxisError` — callers fall back to the
    one-shot XLA collective.

    ``factors``/``links`` are the planned *stage order* (``plan_axis_order``
    / ``plan_reduce_scatter_order`` output); ``shard_bytes`` is the
    scattered-end payload, as everywhere in this module.  For ``ar`` the
    modeled chain is the full 2k-stage RS+AG pipeline.  The hybrid
    candidate (chunk wavefront over per-hop ring stages) reuses the perhop
    ``stage_modes`` and the chunked candidate's power-of-two/packet-clamped
    chunk scan, so it degenerates exactly to perhop at C=1 and to chunked
    when no stage runs as a ring — ties resolve to the simpler mode.
    """
    if health is not None and not health.is_healthy:
        names = (tuple(axis_names) if axis_names is not None
                 else (None,) * len(links))
        if len(names) != len(links):
            raise ValueError(
                f"axis_names length {len(names)} != links length {len(links)}")
        links = [health.degrade_link(nm, l) for nm, l in zip(names, links)]
    stages = _stage_chain(factors, links, shard_bytes, collective)

    oneshot = sum(s.time_s for s in stages)

    if collective_kind(collective).two_phase:
        num_chunks, chunked = _best_chunks(
            lambda c: [
                t.time_s
                for t in _stage_chain(factors, links, shard_bytes / c, collective)
            ],
            max_chunks, shard_bytes=shard_bytes, packet_bytes=packet_bytes,
        )
    else:
        num_chunks, chunked = choose_num_chunks(
            factors, links, shard_bytes, max_chunks=max_chunks,
            collective=collective, packet_bytes=packet_bytes,
        )

    perhop = 0.0
    stage_modes: List[str] = []
    exposed: List[float] = []
    hidden: List[float] = []
    for s in stages:
        t_barrier = s.time_s
        t_ring = perhop_stage_time(s.factor, s.payload_bytes, s.link)
        # a 2-participant stage has a single hop — nothing to pipeline; keep
        # the XLA collective (stage_mode "oneshot") and its barrier cost
        if s.factor > 2 and t_ring < t_barrier:
            stage_modes.append("ring")
            perhop += t_ring
            e, h = _stage_exposure(s.factor, s.payload_bytes, s.link)
        else:
            stage_modes.append("oneshot")
            perhop += t_barrier
            e, h = (s.factor - 1) * s.payload_bytes, 0.0
        exposed.append(e)
        hidden.append(h)

    # hybrid: the chunk wavefront over the per-hop stage chain — per chunk,
    # ring stages cost the overlap max-form and oneshot stages the barrier,
    # each on a 1/C payload (stage payloads are linear in the shard)
    def hybrid_stage_times(c: int) -> List[float]:
        return [
            perhop_stage_time(s.factor, s.payload_bytes / c, s.link)
            if m == "ring"
            else (s.factor - 1) * (s.link.alpha_s
                                   + (s.payload_bytes / c) / s.link.bandwidth_bytes)
            for s, m in zip(stages, stage_modes)
        ]

    hybrid_chunks, hybrid = _best_chunks(
        hybrid_stage_times, max_chunks,
        shard_bytes=shard_bytes, packet_bytes=packet_bytes,
    )

    mode = min(
        (("oneshot", oneshot), ("chunked", chunked), ("perhop", perhop),
         ("hybrid", hybrid)),
        key=lambda kv: kv[1],
    )[0]
    if mode == "chunked" and num_chunks == 1:
        mode = "oneshot"
    if mode == "hybrid" and hybrid_chunks == 1:
        mode = "perhop"  # one-chunk hybrid IS the per-hop schedule
    return HopSchedule(
        mode=mode,
        stage_modes=tuple(stage_modes),
        num_chunks=num_chunks,
        oneshot_time_s=oneshot,
        chunked_time_s=chunked,
        perhop_time_s=perhop,
        stage_exposed_bytes=tuple(exposed),
        stage_hidden_bytes=tuple(hidden),
        stages=tuple(stages),
        collective=collective,
        shard_bytes=float(shard_bytes),
        hybrid_time_s=hybrid,
        hybrid_chunks=hybrid_chunks,
    )


# --------------------------------------------------------------------------
# latency-regime plans (recursive-doubling pairwise exchange)
# --------------------------------------------------------------------------

# collectives the pairwise-exchange structure covers: a2a's exchange traffic
# already moves a constant payload per stage and gains nothing from it.
_LATENCY_COLLECTIVES = ("ag", "rs", "ar")


def _pow2_exponent(n: int) -> Optional[int]:
    """log2(n) when n is a power of two, else None."""
    if n >= 1 and (n & (n - 1)) == 0:
        return n.bit_length() - 1
    return None


def _latency_plan_for_order(
    chain: Sequence[Tuple[Optional[str], int, LinkSpec]],
    shard_bytes: float,
    collective: str,
    *,
    canonical_names: Optional[Sequence[Optional[str]]] = None,
):
    """Build the CollectivePlan for one expanded factor-2 chain.

    ``chain`` is the all-gather-order stage list, every entry ``(name, 2,
    link)`` — one bidirectional pairwise-exchange round per stage
    (recursive doubling: k = log2(n) rounds instead of an m-ary ring's
    m-1 hops per stage).  Execution-order derivation per collective
    mirrors ``search_stage_orders``: RS executes the reverse, AR the
    reverse (its RS half) plus that half's mirror.  Returns ``(plan,
    total_electrical_s)`` — the closed-form alpha-dominated cost
    ``sum_j (alpha_j + payload_j / B_j)`` (the barrier stage time at
    factor 2), which for a homogeneous AG telescopes to
    ``k*alpha + (n-1)*shard/B``.
    """
    from .plan_ir import CollectivePlan, PlanStage  # local: avoid a cycle

    kind = collective_kind(collective)
    ag_names = tuple(a[0] for a in chain)
    if kind.two_phase:
        exec_chain = tuple(reversed(chain))  # the RS half's order
        rs_names = tuple(reversed(ag_names))
        plan_names = rs_names + tuple(reversed(rs_names))
    elif kind.chain == "reversed":
        exec_chain = tuple(reversed(chain))
        plan_names = tuple(reversed(ag_names))
    else:  # forward: ag executes the chain directly
        exec_chain = tuple(chain)
        plan_names = ag_names
    stages = _stage_chain(
        [a[1] for a in exec_chain], [a[2] for a in exec_chain],
        shard_bytes, collective,
    )
    ir_stages = tuple(
        PlanStage(factor=s.factor, mode="exchange",
                  payload_bytes=s.payload_bytes, axis=name, link=s.link)
        for s, name in zip(stages, plan_names)
    )
    total = sum(s.time_s for s in stages)
    meta = {"source": "latency", "regime": "latency",
            "modeled": {"latency": total}}
    if canonical_names is not None and all(
            nm is not None for nm in canonical_names):
        meta["axis_names"] = tuple(canonical_names)
    plan = CollectivePlan(
        collective=collective,
        n=math.prod(a[1] for a in chain),
        shard_bytes=float(shard_bytes),
        stages=ir_stages,
        mode="oneshot",
        num_chunks=1,
        meta=meta,
    )
    return plan, total


def plan_latency_collective(
    axes: Sequence[Tuple[Optional[str], int, LinkSpec]],
    shard_bytes: float,
    *,
    collective: str = "ag",
    health=None,
):
    """Latency-optimal small-message plan: every stage a factor-2
    bidirectional pairwise-exchange round (recursive doubling /
    short-circuit style), picked over axis permutations by the closed-form
    alpha-dominated electrical cost.

    Each axis of size ``2^m`` expands into ``m`` contiguous exchange
    rounds over that axis's link; the permutation search orders whole axes
    (rounds of one axis stay contiguous — the executor relies on it).
    ``shard_bytes`` is the scattered-end payload, as everywhere in this
    module.  ``health`` plans in the degraded world (per-axis link
    derating) — but any DEAD ring direction disqualifies the whole
    family, because every exchange round moves payload both ways.

    Returns the best CollectivePlan (stages carry ``mode="exchange"``,
    ``meta["regime"] == "latency"``), or ``None`` when the structure does
    not apply: a collective outside ag/rs/ar, a non-power-of-two axis
    size, a degenerate n < 2, or a dead direction.
    """
    if collective not in _LATENCY_COLLECTIVES:
        return None
    norm: List[Tuple[Optional[str], int, LinkSpec, int]] = []
    for name, size, link in axes:
        m = _pow2_exponent(int(size))
        if m is None:
            return None
        if health is not None and not health.is_healthy:
            link = health.degrade_link(name, link)
        norm.append((name, int(size), link, m))
    if math.prod(a[1] for a in norm) < 2:
        return None
    if health is not None and health.dead_directions([a[0] for a in norm]):
        return None  # exchange rounds need both ring directions alive
    canonical = tuple(a[0] for a in norm)
    best = None
    best_key = None
    for perm in itertools.permutations(norm):
        chain = tuple(
            (name, 2, link)
            for name, _size, link, m in perm
            for _ in range(m)
        )
        plan, total = _latency_plan_for_order(
            chain, shard_bytes, collective, canonical_names=canonical)
        key = (total, tuple(str(a[0]) for a in chain))
        if best_key is None or key < best_key:
            best, best_key = plan, key
    return best


def latency_crossover_bytes(
    axes: Sequence[Tuple[Optional[str], int, LinkSpec]],
    *,
    collective: str = "ar",
    backend: str = "electrical",
    system=None,
    health=None,
    lo_bytes: float = 64.0,
    hi_bytes: float = float(1 << 26),
) -> Optional[float]:
    """Modeled alpha/bandwidth crossover: the shard size (bytes) where the
    best ring-family plan catches up with the latency plan.

    For shards strictly below the returned size the latency plan is
    modeled cheaper than every ring-mode plan; at or above it the ring
    family wins.  ``backend`` picks the cost world ("electrical" LinkSpec
    alpha+beta, or "optical" Eq. 3 on the RWA lowering under ``system``).
    Returns ``None`` when the latency structure does not apply to
    ``axes``/``collective``; ``0.0`` when the ring family already wins at
    ``lo_bytes`` (latency never pays); ``inf`` when latency still wins at
    ``hi_bytes``.
    """
    from .cost_model import price  # lazy: cost_model imports us

    if backend not in ("electrical", "optical"):
        raise ValueError(f"backend must be electrical|optical, got {backend!r}")
    if plan_latency_collective(
            axes, lo_bytes, collective=collective, health=health) is None:
        return None

    def latency_time(s: float) -> float:
        plan = plan_latency_collective(
            axes, s, collective=collective, health=health)
        if backend == "electrical":
            return price(plan).total_s
        return price(plan, system, health=health).total_s

    def ring_time(s: float) -> float:
        if backend == "optical":
            return search_stage_orders(
                axes, s, collective=collective, backend="optical",
                system=system, health=health, include_latency=False,
            ).best.optical_s
        best = math.inf
        for perm in itertools.permutations(axes):
            sched = choose_hop_schedule(
                [a[1] for a in perm], [a[2] for a in perm], s,
                collective=collective, health=health,
                axis_names=[a[0] for a in perm],
            )
            best = min(best, sched.time_s)
        return best

    def margin(s: float) -> float:
        # > 0 where the latency plan is strictly cheaper
        return ring_time(s) - latency_time(s)

    if margin(lo_bytes) <= 0.0:
        return 0.0
    lo = lo_bytes
    while lo < hi_bytes:
        nxt = min(lo * 2.0, hi_bytes)
        if margin(nxt) <= 0.0:
            break
        lo = nxt
        if lo >= hi_bytes:
            return math.inf
    hi = min(lo * 2.0, hi_bytes)
    # log-space bisection down to ~1-byte resolution on [lo, hi]
    for _ in range(64):
        if hi - lo <= 1.0:
            break
        mid = math.sqrt(lo * hi)
        if margin(mid) > 0.0:
            lo = mid
        else:
            hi = mid
    return hi


# --------------------------------------------------------------------------
# cross-world stage-order search (electrical AND optical pricing)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class OrderCandidate:
    """One searched stage order, priced under BOTH cost worlds.

    ``order`` is the all-gather-order axis naming of the candidate (the RS
    execution order is its reverse, the AR chain RS-order + reversed — one
    AG permutation determines all three); ``plan`` is the full
    CollectivePlan ``choose_hop_schedule`` emitted for it, the very object
    the executor would interpret.  ``electrical_s`` is ``price(plan)`` (the
    LinkSpec model of the plan's chosen mode), ``optical_s``/
    ``optical_steps`` are Eq. 3 on the RWA-lowered schedule
    (``price(plan, system)`` == ``simulate(schedule_from_ir(plan, w))``).

    ``regime`` names the candidate family: ``"bandwidth"`` for the ring
    chains, ``"latency"`` for the recursive-doubling exchange plans (whose
    ``order`` is the EXPANDED per-round axis naming, e.g. ``("b","b","a")``
    for a 4×2 mesh gathered b-first).

    ``reconfigurations`` counts the circuit/topology changes the lowered
    schedule needs on a reconfigurable photonic fabric (0 = the candidate
    holds one circuit for the whole collective).  The count is structural
    — it is reported even when ``system.circuit_reconfig_s == 0`` — so
    the hold-vs-reconfigure decision can be ranked independently of the
    delay calibration; the delay itself is already inside ``optical_s``.
    """

    order: Tuple[str, ...]
    plan: object  # CollectivePlan (kept untyped: plan_ir imports us lazily)
    electrical_s: float
    optical_s: float
    optical_steps: int
    regime: str = "bandwidth"
    reconfigurations: int = 0


def _order_rank_key(backend: str):
    """Deterministic ranking key: backend time, then regime ("bandwidth"
    sorts first — equal-cost ties resolve to the simpler ring plan), then
    the (stringified — names may be None) order tuple."""
    time_of = {"electrical": lambda c: c.electrical_s,
               "optical": lambda c: c.optical_s}[backend]
    return lambda c: (time_of(c), c.regime, tuple(str(n) for n in c.order))


@dataclass(frozen=True)
class OrderSearch:
    """Result of ``search_stage_orders``: candidates ranked by ``backend``."""

    collective: str
    backend: str
    candidates: Tuple[OrderCandidate, ...]
    capped: bool = False  # True when max_candidates truncated the space
    # AG orders excluded because their lowered schedule would cross a ring
    # direction the health table marks dead (empty when searched healthy)
    pruned: Tuple[Tuple, ...] = ()

    @property
    def best(self) -> OrderCandidate:
        return self.candidates[0]

    def best_by(self, backend: str) -> OrderCandidate:
        """The winner under one backend regardless of the search backend
        (deterministic: time, then order, breaks ties)."""
        return min(self.candidates, key=_order_rank_key(backend))

    @property
    def flipped(self) -> bool:
        """True iff the two worlds GENUINELY disagree: the optical winner
        is a different order than the electrical winner AND strictly
        cheaper under Eq. 3.  Equal-cost candidates rank by the
        deterministic order tie-break, so differing order tuples alone
        (e.g. every stage fits one step at large w) are a tie, not a
        flip."""
        eb = self.best_by("electrical")
        ob = self.best_by("optical")
        return (eb.order != ob.order
                and ob.optical_s < eb.optical_s * (1.0 - 1e-9))

    @property
    def regime_flipped(self) -> bool:
        """True iff the two worlds disagree about the plan FAMILY — one
        backend's winner is a latency (exchange) plan and the other's a
        ring chain, with the optical choice strictly cheaper under Eq. 3
        (same strictness as ``flipped``)."""
        eb = self.best_by("electrical")
        ob = self.best_by("optical")
        return (eb.regime != ob.regime
                and ob.optical_s < eb.optical_s * (1.0 - 1e-9))


def _candidate_factorizations(
    axes: Sequence[Tuple[Optional[str], int, LinkSpec]], max_k: Optional[int]
) -> List[Tuple[Tuple[Optional[str], int, LinkSpec], ...]]:
    """Stage chains to search: every permutation of the given axes; for a
    SINGLE unnamed axis additionally its balanced k-stage factorizations
    (the paper world, where sub-axis stages are executable) — named mesh
    axes are atomic, the engine cannot split a shard_map axis.

    Asking for ``max_k > 1`` sub-axis factorization anywhere else is a
    hard error rather than a silent no-op: a factored stage over a NAMED
    mesh axis (or a multi-axis chain) would name sub-groups no
    ``shard_map`` axis exists for, producing an order the executor cannot
    lower to ppermutes."""
    if max_k is not None and max_k > 1 and not (
            len(axes) == 1 and axes[0][0] is None):
        raise ValueError(
            f"max_k={max_k} sub-axis factorization only applies to a "
            f"single unnamed paper-world axis; got "
            f"{[(a[0], a[1]) for a in axes]} — named mesh axes are atomic "
            "(shard_map cannot split a physical axis into ppermute "
            "sub-stages); drop max_k or search the unnamed single-axis "
            "world")
    base: List[Tuple] = [tuple(p) for p in itertools.permutations(axes)]
    if len(axes) == 1 and axes[0][0] is None and axes[0][1] > 1:
        _, n, link = axes[0]
        kmax = max_k or max(1, math.ceil(math.log2(max(n, 2))))
        seen = {(n,)}
        for k in range(2, kmax + 1):
            factors = tuple(balanced_factors(n, k))
            for perm in set(itertools.permutations(factors)):
                if perm in seen:
                    continue
                seen.add(perm)
                base.append(tuple((None, f, link) for f in perm))
    return base


def search_stage_orders(
    axes: Sequence,
    shard_bytes: float,
    *,
    collective: str = "ag",
    backend: str = "electrical",
    system=None,
    max_chunks: int = 8,
    max_candidates: int = 24,
    max_k: Optional[int] = None,
    packet_bytes: int = TERARACK.packet_bytes,
    health=None,
    include_latency: bool = True,
    reconfig: str = "auto",
) -> OrderSearch:
    """Cross-world stage-order search: enumerate candidate stage
    factorizations/permutations, price each full CollectivePlan through
    BOTH cost backends, rank by ``backend``.

    ``include_latency`` additionally enumerates the recursive-doubling
    exchange family (``plan_latency_collective``'s candidates, one per
    axis permutation, when the collective and sizes admit them) so the
    ranking — and ``meta["order_search"]`` downstream — records REGIME
    flips, not just order flips.  Latency candidates ride outside the
    ``max_candidates`` cap (the family adds at most axes! entries) and
    are all pruned whenever any ring direction is dead: exchange rounds
    are bidirectional.

    ``axes`` entries are ``(name, size, link)`` (name may be None for
    paper-world plans, which then also search balanced factorizations of a
    single axis).  Candidates are AG orders; every registered collective
    derives its execution order from each AG permutation via its chain
    descriptor (RS = reverse, AR = RS order + its reverse, A2A = the order
    itself), so one enumeration covers them all.

    The electrical backend prices each candidate's chosen-mode LinkSpec
    time (== ``choose_hop_schedule``'s decision signal).  The optical
    backend lowers the same plan through ``schedule_from_ir`` and prices
    Eq. 3 on the RWA step count — the stage ORDER changes the step count
    (stage 1 routes on the whole ring, deeper stages inside shrinking
    segments), which is why the two worlds can disagree; on asymmetric
    LinkSpec tables the optical winner is often NOT slow-axis-first.
    ``max_candidates`` caps the enumeration (``OrderSearch.capped`` reports
    truncation); ranking ties break on the order tuple, so results are
    deterministic.

    ``health`` searches the DEGRADED world: axis links are derated by their
    best alive direction before enumeration (a fully dead axis raises
    :class:`~repro_torch.core.health.DeadAxisError`), the optical backend prices
    with the lost-wavelength union removed from ``w``, and any candidate
    whose RWA-lowered schedule crosses a dead ring direction is pruned
    (``OrderSearch.pruned`` lists the excluded orders).  If every candidate
    is pruned, :class:`~repro_torch.core.health.DeadDirectionError` is raised —
    callers fall back to the one-shot collective.

    ``reconfig`` constrains the hold-vs-reconfigure decision on a
    reconfigurable photonic fabric.  ``"auto"`` (default) ranks the full
    space — the per-event ``system.circuit_reconfig_s`` delay (minus any
    SWOT overlap behind the previous stage's in-flight last step) is part
    of each candidate's ``optical_s``, so the ranking itself decides
    whether fewer-steps-plus-delay beats hold-the-circuit.  ``"hold"``
    keeps only candidates with ``reconfigurations == 0`` (one circuit for
    the whole collective); ``"reconfigure"`` keeps only candidates that
    pay at least one topology change.  A constraint that empties a
    non-empty space raises ``ValueError`` (e.g. ``"hold"`` on a
    multi-stage named mesh, where every chain must re-circuit between
    axes).
    """
    from .cost_model import OpticalSystem, price  # lazy: cost_model imports us
    from .schedule import schedule_from_ir  # lazy: avoid a cycle

    if backend not in ("electrical", "optical"):
        raise ValueError(
            f"backend must be electrical|optical, got {backend!r}")
    if reconfig not in ("auto", "hold", "reconfigure"):
        raise ValueError(
            f"reconfig must be auto|hold|reconfigure, got {reconfig!r}")
    norm: List[Tuple[Optional[str], int, LinkSpec]] = []
    for a in axes:
        name, size, link = a
        if health is not None and not health.is_healthy:
            link = health.degrade_link(name, link)
        norm.append((name, int(size), link))
    dead_dirs = (health.dead_directions([a[0] for a in norm])
                 if health is not None else frozenset())
    chains = _candidate_factorizations(norm, max_k)
    capped = len(chains) > max_candidates
    chains = chains[:max_candidates]

    sys = system if system is not None else TERARACK
    if not isinstance(sys, OpticalSystem):
        raise TypeError(f"system must be an OpticalSystem, got {sys!r}")

    cands: List[OrderCandidate] = []
    pruned: List[Tuple] = []
    for chain in chains:
        ag_names = tuple(a[0] for a in chain)
        kind = collective_kind(collective)
        if kind.two_phase:
            exec_chain = tuple(reversed(chain))  # the RS half's order
            rs_names = tuple(reversed(ag_names))
            plan_names = rs_names + tuple(reversed(rs_names))
        elif kind.chain == "reversed":
            exec_chain = tuple(reversed(chain))
            plan_names = tuple(reversed(ag_names))
        else:  # forward: ag, a2a execute the candidate order directly
            exec_chain = chain
            plan_names = ag_names
        sched = choose_hop_schedule(
            [a[1] for a in exec_chain], [a[2] for a in exec_chain],
            shard_bytes, max_chunks=max_chunks, collective=collective,
            packet_bytes=packet_bytes,
        )
        names = plan_names if all(n is not None for n in ag_names) else None
        plan = sched.to_ir(names)
        if dead_dirs:
            lowered = schedule_from_ir(plan, sys.wavelengths, health=health)
            if any(tx.direction in dead_dirs for tx in lowered.txs):
                pruned.append(ag_names)
                continue
        opt = price(plan, sys, health=health)
        cands.append(OrderCandidate(
            order=ag_names,
            plan=plan,
            electrical_s=price(plan).total_s,
            optical_s=opt.total_s,
            optical_steps=opt.steps,
            reconfigurations=opt.reconfigurations,
        ))
    if (include_latency and collective in _LATENCY_COLLECTIVES
            and all(_pow2_exponent(a[1]) is not None for a in norm)
            and math.prod(a[1] for a in norm) >= 2):
        seen_lat = set()
        for perm in itertools.permutations(norm):
            chain = tuple(
                (name, 2, link)
                for name, size, link in perm
                for _ in range(_pow2_exponent(size))
            )
            if chain in seen_lat:
                continue
            seen_lat.add(chain)
            lat_names = tuple(a[0] for a in chain)
            if dead_dirs:
                # every exchange round moves payload both ways around the
                # ring — any dead direction kills the whole family
                pruned.append(lat_names)
                continue
            plan, _ = _latency_plan_for_order(
                chain, shard_bytes, collective,
                canonical_names=[a[0] for a in norm])
            opt = price(plan, sys, health=health)
            cands.append(OrderCandidate(
                order=lat_names,
                plan=plan,
                electrical_s=price(plan).total_s,
                optical_s=opt.total_s,
                optical_steps=opt.steps,
                regime="latency",
                reconfigurations=opt.reconfigurations,
            ))
    if reconfig != "auto" and cands:
        keep = [c for c in cands
                if (c.reconfigurations == 0) == (reconfig == "hold")]
        if not keep:
            counts = sorted({c.reconfigurations for c in cands})
            raise ValueError(
                f"reconfig={reconfig!r} excludes every {collective} "
                f"candidate: the searched space has reconfiguration "
                f"counts {counts} only (a multi-stage named mesh must "
                "re-circuit between axes, so 'hold' needs a single-stage "
                "or single-axis world); use reconfig='auto'")
        cands = keep
    if not cands:
        from .health import DeadDirectionError  # lazy: avoid a cycle
        raise DeadDirectionError(
            f"every {collective} stage-order candidate crosses a dead ring "
            f"direction {sorted(dead_dirs)} "
            f"(pruned {len(pruned)} orders: {pruned[:4]}...); fall back to "
            "the one-shot collective")
    cands.sort(key=_order_rank_key(backend))
    return OrderSearch(collective=collective, backend=backend,
                       candidates=tuple(cands), capped=capped,
                       pruned=tuple(pruned))


# --------------------------------------------------------------------------
# collective-matmul fusion (gather/compute overlap)
# --------------------------------------------------------------------------

def matmul_block_time(
    rows: int, inner: int, cols: int, *, peak_flops: float = MXU_PEAK_FLOPS
) -> float:
    """Roofline time for one (rows × inner) @ (inner × cols) block matmul."""
    return 2.0 * rows * inner * cols / peak_flops


@dataclass(frozen=True)
class FusedMatmulPlan:
    """Fuse-or-not decision for all-gather→matmul / matmul→reduce-scatter.

    ``fused_time_s`` models the per-hop schedule where each gathered (or
    about-to-be-scattered) block's matmul runs while the next hop is in
    flight; ``unfused_time_s`` is the blocking collective followed (or
    preceded) by one full matmul.  ``hidden_comm_s`` is the transfer time the
    fused schedule hides behind compute.
    """

    fuse: bool
    fused_time_s: float
    unfused_time_s: float
    hidden_comm_s: float


def plan_collective_matmul(
    factors: Sequence[int],
    links: Sequence[LinkSpec],
    shard_bytes: float,
    block_compute_s: float,
    *,
    kernel_alpha_s: float = 2e-6,
) -> FusedMatmulPlan:
    """Decide whether to decompose a gather-adjacent matmul per hop.

    ``block_compute_s`` is the matmul time for ONE device block (the
    scattered shard's worth of rows); ``kernel_alpha_s`` is the per-block
    launch/efficiency penalty of running N skinny matmuls instead of one wide
    one — the only force that can make fusion lose under this model.

    Fused schedule over the AG stage chain (payload and blocks-per-hop grow
    stage by stage): each hop's transfer runs concurrently with the matmul of
    the blocks the *previous* hop delivered, so a stage costs
    ``(f-1)·max(hop, blocks·t_blk)`` and only the final delivery's matmul is
    exposed.  Applies symmetrically to the reduce-scatter dual (just-in-time
    block matmuls feeding the ring).
    """
    t_blk = block_compute_s + kernel_alpha_s
    n = math.prod(factors)

    payload = float(shard_bytes)
    blocks = 1  # device blocks carried per hop at this stage
    fused = block_compute_s  # local block's matmul (overlaps the first send)
    comm = 0.0
    exposed_comm = 0.0
    trailing_blocks = 0  # per-hop block count of the last stage with hops
    for f, link in zip(factors, links):
        if f <= 1:
            continue
        hop = link.alpha_s + payload / link.bandwidth_bytes
        fused += (f - 1) * max(hop, blocks * t_blk)
        comm += (f - 1) * hop
        exposed_comm += (f - 1) * max(0.0, hop - blocks * t_blk)
        trailing_blocks = blocks
        payload *= f
        blocks *= f
    # the last hop's delivery is multiplied after the wire goes quiet
    fused += trailing_blocks * t_blk

    unfused = comm + n * block_compute_s
    return FusedMatmulPlan(
        fuse=fused < unfused,
        fused_time_s=fused,
        unfused_time_s=unfused,
        hidden_comm_s=comm - exposed_comm,
    )
