"""Communication-time model (paper Eq. 3 / Thm 3) + TeraRack constants (§IV-A).

``T_comm = (d/B + a) * S`` — S communication steps, each transferring one
item of size d per wavelength at per-wavelength bandwidth B, plus a fixed
per-step overhead ``a`` (MRR reconfiguration + O/E/O conversion).

The paper treats ``a`` as a constant; we additionally expose the packet/flit
accounting behind it (128-byte packets, 32-byte flits, one cycle per flit for
O/E/O at the 40 Gbps line rate) for the detailed simulator.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, replace

__all__ = ["OpticalSystem", "TERARACK", "CircuitReconfig", "step_time",
           "eq3_time", "allgather_time", "eq3_overlap_time",
           "exposed_hidden_bytes", "PriceReport", "price",
           "schedule_step_times", "transfer_time", "derive_wavelengths"]


@dataclass(frozen=True)
class OpticalSystem:
    """TeraRack-style WDM ring parameters (paper §IV-A defaults).

    ``mrr_reconfig_s`` is the paper's PER-STEP overhead ``a`` (MRR tuning
    within a fixed circuit configuration).  ``circuit_reconfig_s`` is the
    PER-EVENT topology-reconfiguration delay a circuit-switched photonic
    fabric pays when the lightpath layout itself changes between stages
    (ring -> segmented lines, segment size changes) — zero by default, so
    the fixed-ring world of PRs 3-8 is unchanged.  ``reconfig_overlap``
    enables the SWOT-style overlap: a reconfiguration event starts while
    the previous stage's LAST step is still transmitting, so only
    ``max(0, circuit_reconfig_s - last_step_s)`` is exposed."""

    n_nodes: int = 1024
    wavelengths: int = 64  # w, per fiber direction
    bandwidth_per_wavelength: float = 40e9  # bits/s
    mrr_reconfig_s: float = 25e-6  # MRR reconfiguration delay (per step)
    packet_bytes: int = 128
    flit_bytes: int = 32
    oeo_cycles_per_flit: int = 1
    circuit_reconfig_s: float = 0.0  # per-event circuit/topology change
    reconfig_overlap: bool = True  # hide reconfig behind in-flight last step

    @property
    def flit_time_s(self) -> float:
        """Time to serialize one flit at the line rate = the 'cycle' used for
        O/E/O conversion accounting (one cycle per flit)."""
        return self.flit_bytes * 8 / self.bandwidth_per_wavelength

    def oeo_delay_s(self, chunk_bytes: float) -> float:
        flits = math.ceil(chunk_bytes / self.flit_bytes)
        return flits * self.oeo_cycles_per_flit * self.flit_time_s


TERARACK = OpticalSystem()


@dataclass(frozen=True)
class CircuitReconfig:
    """Circuit-reconfiguration accounting of one priced/simulated schedule.

    ``events`` counts the stage boundaries whose circuit signature changed
    (a topology reconfiguration of the photonic fabric); ``exposed_s`` is
    the wall time those events add after the SWOT overlap — with
    ``reconfig_overlap`` each event hides behind the previous stage's
    in-flight last step, without it the full ``circuit_reconfig_s`` is
    exposed per event.  Events are counted even at zero delay, so planners
    can rank hold-vs-reconfigure candidates independently of the current
    delay calibration."""

    events: int = 0
    exposed_s: float = 0.0


def derive_wavelengths(links, base: "OpticalSystem" = None) -> int:
    """Derive a per-mesh wavelength budget from calibrated LinkSpecs.

    The busiest axis's fitted bandwidth, expressed in per-wavelength WDM
    channels of ``base.bandwidth_per_wavelength`` bits/s and clamped to
    ``[1, base.wavelengths]`` — so ``--calibrate`` output sizes the optical
    pricer's ``w`` instead of hand-picking ``--optical-w``.  ``links`` is
    any iterable/mapping of LinkSpec-shaped objects (``bandwidth_bytes``).
    """
    base = base if base is not None else TERARACK
    specs = links.values() if hasattr(links, "values") else links
    bws = [float(l.bandwidth_bytes) for l in specs
           if getattr(l, "bandwidth_bytes", None)]
    if not bws:
        return base.wavelengths
    per_wl_bytes = base.bandwidth_per_wavelength / 8.0
    return max(1, min(base.wavelengths, math.ceil(max(bws) / per_wl_bytes)))


def transfer_time(model, nbytes: float) -> float:
    """One point-to-point transfer priced under either cost world.

    ``model`` is an :class:`OpticalSystem` (the paper's Eq.-3 step model:
    ``d/B + a``) or a ``LinkSpec``-shaped object (the electrical alpha/
    bandwidth model: ``α + d/B``).  This is the request-transmission
    primitive the cluster simulator (``repro.cluster``) prices client→
    replica hops with, so the serving layer sees the SAME fabric models
    the collectives plan against.
    """
    if isinstance(model, OpticalSystem):
        return step_time(model, nbytes)
    return model.alpha_s + nbytes / model.bandwidth_bytes


def step_time(sys: OpticalSystem, chunk_bytes: float, *, detailed: bool = False) -> float:
    """Duration of one communication step carrying ``chunk_bytes`` (= d).

    paper-style (default):  d/B + a,  a = MRR reconfiguration delay only.
    detailed:               adds flit-level O/E/O conversion latency.
    """
    serial = chunk_bytes * 8 / sys.bandwidth_per_wavelength
    a = sys.mrr_reconfig_s + (sys.oeo_delay_s(chunk_bytes) if detailed else 0.0)
    return serial + a


def eq3_time(sys: OpticalSystem, d_bytes: float, steps: int, *, detailed: bool = False) -> float:
    """Eq. (3): T = (d/B + a) * S."""
    return step_time(sys, d_bytes, detailed=detailed) * steps


def allgather_time(
    sys: OpticalSystem, message_bytes: float, steps: int, *, detailed: bool = False
) -> float:
    """All-gather wall time when every node contributes ``message_bytes``."""
    return eq3_time(sys, message_bytes, steps, detailed=detailed)


def eq3_overlap_time(
    sys: OpticalSystem, d_bytes: float, steps: int, *, detailed: bool = False
) -> float:
    """Per-hop overlapped variant of Eq. (3).

    With double-buffered hops the fixed per-step overhead ``a`` of step t+1
    (MRR reconfiguration / launch) runs while step t's payload is still
    serializing, so only the longer of the two chains is exposed:

        T = max(S·d/B + a,  S·a + d/B)

    Bandwidth-bound steps hide all but one ``a``; latency-bound steps hide
    all but one serialization.  Eq. (3) itself, ``(d/B + a)·S``, is the
    no-overlap upper bound.
    """
    serial = d_bytes * 8 / sys.bandwidth_per_wavelength
    a = sys.mrr_reconfig_s + (sys.oeo_delay_s(d_bytes) if detailed else 0.0)
    return max(steps * serial + a, steps * a + serial)


# --------------------------------------------------------------------------
# unified IR pricing — one entry point for both cost worlds
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PriceReport:
    """What one CollectivePlan costs under one transport model.

    ``stage_times_s`` attributes the total per IR stage; under the chunked
    mode they are the per-chunk pipeline stage costs, so
    ``total_s = sum + (C-1)·max`` (the pipeline makespan).  ``steps`` is
    the optical backend's communication-step count (None for electrical).
    ``reconfigurations``/``reconfig_exposed_s`` report the optical world's
    circuit-reconfiguration events and their exposed (post-overlap) wall
    time — zero for the electrical backend and in the fixed-circuit world
    (``circuit_reconfig_s == 0`` still counts events, exposes nothing).
    """

    backend: str  # "linkspec" | "optical"
    mode: str
    total_s: float
    stage_times_s: tuple
    steps: int = None
    num_chunks: int = 1
    reconfigurations: int = 0
    reconfig_exposed_s: float = 0.0


def _price_linkspec(plan, health=None) -> PriceReport:
    from .planner import perhop_stage_time, pipeline_makespan  # lazy: planner imports us

    for s in plan.stages:
        if s.link is None:
            raise ValueError(
                f"stage {s} has no LinkSpec; the electrical backend needs one")

    if health is not None and not health.is_healthy:
        # derate each stage's link by its axis's best alive direction; a
        # fully dead axis raises DeadAxisError (no staged plan crosses it)
        plan = dataclasses.replace(
            plan,
            stages=tuple(
                dataclasses.replace(s, link=health.degrade_link(s.axis, s.link))
                for s in plan.stages))

    def barrier(s, payload):
        return (s.factor - 1) * (s.link.alpha_s + payload / s.link.bandwidth_bytes)

    if plan.mode in ("chunked", "hybrid") and plan.num_chunks > 1:
        # C-chunk wavefront makespan over per-chunk stage times.  Chunked
        # pipelines blocking whole-stage collectives; hybrid pipelines the
        # SAME wavefront over per-hop ring stages, so a stage whose hop
        # structure is perhop contributes the overlap max-form on the
        # 1/C-payload chunk instead of the barrier time.
        c = plan.num_chunks
        times = tuple(
            perhop_stage_time(s.factor, s.payload_bytes / c, s.link)
            if plan.mode == "hybrid" and s.mode == "perhop"
            else barrier(s, s.payload_bytes / c)
            for s in plan.stages
        )
        return PriceReport("linkspec", plan.mode,
                           pipeline_makespan(times, c), times, num_chunks=c)
    times = []
    for s in plan.stages:
        if plan.mode in ("perhop", "hybrid") and s.mode == "perhop":
            times.append(perhop_stage_time(s.factor, s.payload_bytes, s.link))
        else:
            times.append(barrier(s, s.payload_bytes))
    return PriceReport("linkspec", plan.mode, sum(times), tuple(times),
                       num_chunks=plan.num_chunks)


def _circuit_reconfigurations(sched, sys: "OpticalSystem", per_step):
    """Circuit-reconfiguration events of a lowered schedule and their
    exposed delays, attributed per execution-order stage.

    ``sched.meta["circuits"]`` (written by ``schedule_from_ir`` alongside
    ``stage_ranges``) carries one circuit signature per lowered stage —
    ``("ring", n)`` for whole-ring stages, ``("line", seg)`` for
    segmented-line stages.  Walking the NON-EMPTY stages in schedule-step
    order, every boundary whose signature changes is one reconfiguration
    event; the initial circuit setup is free.  With ``reconfig_overlap``
    the event hides behind the previous stage's in-flight last step
    (``max(0, circuit_reconfig_s - last_step_s)`` exposed), otherwise the
    full delay is exposed.  Each event's exposure is charged to the
    FOLLOWING stage (execution-order index), so stage times still sum to
    the total.  Returns ``(events, exposed_s, per_stage_extra)``;
    hand-built schedules without circuit metadata charge nothing.
    """
    circuits = sched.meta.get("circuits")
    ranges = sched.meta.get("stage_ranges")
    if not circuits or ranges is None or len(circuits) != len(ranges):
        return 0, 0.0, None
    # recover schedule order: ranges/circuits are execution-order, but the
    # (start_step, n_steps) tuples carry the true schedule positions
    order = sorted((i for i in range(len(ranges)) if ranges[i][1] > 0),
                   key=lambda i: ranges[i][0])
    extras = [0.0] * len(ranges)
    events, exposed = 0, 0.0
    for prev, cur in zip(order, order[1:]):
        if circuits[prev] == circuits[cur]:
            continue
        events += 1
        delay = sys.circuit_reconfig_s
        if delay > 0.0:
            if sys.reconfig_overlap:
                last = ranges[prev][0] + ranges[prev][1] - 1
                delay = max(0.0, delay - per_step[last])
            extras[cur] += delay
            exposed += delay
    return events, exposed, extras


def schedule_step_times(sched, sys: "OpticalSystem", message_bytes: float,
                        *, detailed: bool = False):
    """Eq.-3 timing of a lowered schedule, burst- and reconfiguration-aware.

    Returns ``(per_step_times, stage_times, total_s, reconfig)`` where
    ``reconfig`` is a :class:`CircuitReconfig`.  A step's duration is
    ``step_time(sys, burst · d)`` where ``burst`` is the largest number
    of items any single lightpath — one ``(wavelength, direction, src,
    dst)`` slot — carries that step.  Ordinary stages put one item per
    lightpath (burst 1 everywhere), and then the arithmetic is EXACTLY the
    historical ``per_step · steps`` products (no summation drift); only
    exchange stages, whose pairwise rounds serialize a pair's whole buffer
    over one lightpath, produce bursts > 1 and per-step summation.  Stage
    attribution uses ``sched.meta["stage_ranges"]`` (execution-order
    ``(start_step, n_steps)`` from ``schedule_from_ir``) and falls back to
    a sequential ``stage_steps`` split for hand-built schedules.

    When ``sys.circuit_reconfig_s > 0`` every circuit-signature change
    between consecutive non-empty stages (``sched.meta["circuits"]``)
    additionally exposes its post-overlap reconfiguration delay, charged
    to the following stage — the single accounting both ``price`` and
    ``optics.simulator.simulate`` consume, so price == simulate stays
    literal in the reconfiguring world.
    """
    bursts = [1] * sched.num_steps
    counts = {}
    for tx in sched.txs:
        key = (tx.step, tx.wavelength, tx.direction, tx.src, tx.dst)
        c = counts.get(key, 0) + 1
        counts[key] = c
        if c > bursts[tx.step]:
            bursts[tx.step] = c
    if all(b == 1 for b in bursts):
        per = step_time(sys, message_bytes, detailed=detailed)
        per_step = [per] * sched.num_steps
        stage_times = tuple(per * s for s in sched.stage_steps)
        total = per * sched.num_steps
    else:
        per_step = [step_time(sys, b * message_bytes, detailed=detailed)
                    for b in bursts]
        ranges = sched.meta.get("stage_ranges")
        if ranges is None:
            ranges = []
            start = 0
            for s in sched.stage_steps:
                ranges.append((start, s))
                start += s
        stage_times = tuple(sum(per_step[a:a + c]) for a, c in ranges)
        total = sum(per_step)
    events, exposed, extras = _circuit_reconfigurations(sched, sys, per_step)
    if exposed > 0.0:
        stage_times = tuple(t + e for t, e in zip(stage_times, extras))
        total += exposed
    return per_step, stage_times, total, CircuitReconfig(events, exposed)


def _price_optical(plan, sys: "OpticalSystem", *, detailed: bool = False,
                   health=None) -> PriceReport:
    from .plan_ir import optical_message_bytes  # lazy: avoid a cycle
    from .schedule import schedule_from_ir  # lazy: avoid a cycle

    sched = schedule_from_ir(plan, sys.wavelengths, health=health)
    # one step moves ONE schedule item per lightpath: the whole shard for
    # gather traffic, a 1/n (origin, destination) block for exchange (a2a)
    # traffic; exchange-stage bursts scale each step's duration
    _, times, total, reconf = schedule_step_times(
        sched, sys, optical_message_bytes(plan), detailed=detailed)
    return PriceReport("optical", plan.mode, total,
                       times, steps=sched.num_steps,
                       num_chunks=plan.num_chunks,
                       reconfigurations=reconf.events,
                       reconfig_exposed_s=reconf.exposed_s)


def plan_exposure(plan) -> tuple:
    """Per-stage (exposed, hidden) byte tuples of a CollectivePlan under
    per-hop execution — same accounting as
    ``HopSchedule.stage_exposed_bytes``/``stage_hidden_bytes``: ring stages
    split by the overlap model, blocking stages expose every moved byte."""
    from .planner import _stage_exposure  # lazy: planner imports us

    exposed, hidden = [], []
    for s in plan.stages:
        if s.mode == "perhop" and s.link is not None:
            e, h = _stage_exposure(s.factor, s.payload_bytes, s.link)
        else:
            e, h = float((s.factor - 1) * s.payload_bytes), 0.0
        exposed.append(e)
        hidden.append(h)
    return tuple(exposed), tuple(hidden)


def price(plan, model=None, *, detailed: bool = False,
          health=None) -> PriceReport:
    """Price one :class:`~repro_torch.core.plan_ir.CollectivePlan` under a model.

    * ``model=None`` (or ``"electrical"``/``"linkspec"``) — the TPU-mesh
      alpha/bandwidth model from each stage's ``LinkSpec``: barrier stages
      cost ``(f-1)·(α + p/B)``, per-hop stages the overlap max-form, the
      chunked mode prices the C-chunk wavefront makespan, and the hybrid
      mode the same makespan over overlapped ring stage times — numerically
      identical to ``core.planner.choose_hop_schedule``'s modeled times for
      the same chain, so planner and pricer cannot drift.
    * ``model=OpticalSystem`` — the paper's Eq.-3 model on the RWA-lowered
      schedule: ``T = (d/B + a) · S`` with S counted by
      ``schedule_from_ir`` — byte-identical to what
      ``optics.simulator.simulate`` reports for the same plan (chunking is
      an executor concept and does not change the optical step structure).

    ``health`` prices the DEGRADED world: the electrical backend scales
    each stage link's bandwidth by the axis's best alive direction (a dead
    axis raises :class:`~repro_torch.core.health.DeadAxisError`), and the optical
    backend lowers with the lost-wavelength union removed from ``w``, so
    its price stays byte-identical to
    ``simulate(schedule_from_ir(plan, w, health=h), ..., health=h)``.
    Degraded prices are monotone: never below the healthy price.
    """
    if model is None or model in ("electrical", "linkspec"):
        return _price_linkspec(plan, health=health)
    if isinstance(model, OpticalSystem):
        return _price_optical(plan, model, detailed=detailed, health=health)
    raise TypeError(f"model must be None, 'electrical' or OpticalSystem, "
                    f"got {model!r}")


def exposed_hidden_bytes(
    sys: OpticalSystem, d_bytes: float, steps: int
) -> tuple:
    """(exposed, hidden) byte split for ``steps`` overlapped hops of size d.

    Bandwidth-bound (d/B >= a): every byte's serialization is on the critical
    path — all S·d bytes exposed, the overlap hides the per-step ``a``s.
    Latency-bound: the ``a`` chain paces the pipeline and all but one
    payload's serialization hides under it.
    """
    serial = d_bytes * 8 / sys.bandwidth_per_wavelength
    total = steps * d_bytes
    if serial >= sys.mrr_reconfig_s:
        return float(total), 0.0
    return float(d_bytes), float(total - d_bytes)
