"""Step-accurate simulator for schedules on the WDM ring.

Executes a :class:`~repro_torch.core.schedule.Schedule` step by step, re-validating
conflict-freedom and causality *as it runs* (a schedule that passes the static
validators also passes here; the simulator is the independent execution path),
and accumulates wall time with the paper's Eq.-3 model — optionally the
detailed packet/flit variant.

This is the measurement backend for the Fig. 4/5/6 and Table I benchmarks.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from ..core.cost_model import OpticalSystem, schedule_step_times
from ..core.schedule import Schedule

__all__ = ["SimReport", "simulate"]


@dataclass(frozen=True)
class SimReport:
    algorithm: str
    n: int
    w: int
    steps: int
    transmissions: int
    time_s: float
    max_link_load: int  # peak per-(direction,link) wavelength usage in a step
    stage_steps: Tuple[int, ...]
    stage_times_s: Tuple[float, ...] = ()  # wall time attributed per stage
    reconfigurations: int = 0  # circuit/topology changes between stages
    reconfig_exposed_s: float = 0.0  # reconfig delay not hidden by overlap

    def speedup_vs(self, other: "SimReport") -> float:
        return other.time_s / self.time_s

    def reduction_vs(self, other: "SimReport") -> float:
        """Paper-style '% communication-time reduction' vs a baseline."""
        return 1.0 - self.time_s / other.time_s


def simulate(
    sched: Schedule,
    sys: OpticalSystem,
    message_bytes: float,
    *,
    detailed: bool = False,
    check: bool = True,
    health=None,
) -> SimReport:
    """Execute ``sched`` step by step.  ``message_bytes`` is the size of ONE
    schedule item (``plan_ir.optical_message_bytes`` for IR-lowered plans:
    the shard for gather traffic, a 1/n block for exchange traffic).

    ``sched.meta["semantics"]`` selects the item model: ``"gather"`` (the
    default) starts node i holding item i and requires every node to end
    with all n items; ``"exchange"`` (a2a) uses the n² (origin,
    destination) item space ``u·n + v`` — node u starts holding
    ``{u·n + v : v}`` and node v must end holding ``{u·n + v : u}``.

    ``health`` (a :class:`~repro_torch.core.health.LinkHealth`) makes the run
    fault-aware: a transmission on a lost wavelength or a dead ring
    direction fails the simulation — the physical channel does not exist.
    ``schedule_from_ir(..., health=...)`` schedules around faults, so a
    consistent plan→schedule→simulate pipeline passes this check by
    construction (price==simulate under faults).
    """
    lost: Set[int] = set()
    dead_dirs: Set[int] = set()
    if health is not None and not health.is_healthy:
        axes = sched.meta.get("axes")
        lost = set(health.lost_for(axes))
        dead_dirs = set(health.dead_directions(axes))
    exchange = sched.meta.get("semantics") == "exchange"
    if exchange:
        holdings: List[Set[int]] = [
            {u * sched.n + v for v in range(sched.n)} for u in range(sched.n)
        ]
    else:
        holdings = [{i} for i in range(sched.n)]
    max_load = 0
    steps = sched.by_step()
    for step_txs in steps:
        wl_used: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
        load: Dict[Tuple[int, int], Set[int]] = defaultdict(set)
        arrivals: Dict[int, Set[int]] = defaultdict(set)
        for tx in step_txs:
            if tx.wavelength in lost:
                raise AssertionError(
                    f"simulator: transmission on LOST wavelength "
                    f"{tx.wavelength} at step {tx.step} "
                    f"({tx.src}->{tx.dst}, links {list(tx.links)}); "
                    f"health: {health.describe()}")
            if tx.direction in dead_dirs:
                raise AssertionError(
                    f"simulator: transmission on DEAD ring direction "
                    f"{tx.direction} at step {tx.step} "
                    f"({tx.src}->{tx.dst}, wl={tx.wavelength}); "
                    f"health: {health.describe()}")
            if check:
                if tx.item not in holdings[tx.src]:
                    raise AssertionError(
                        f"simulator: node {tx.src} lacks item {tx.item} at step {tx.step}"
                    )
                for link in tx.links:
                    key = (tx.direction, link, tx.wavelength)
                    owner = wl_used.get(key)
                    # same-(src,dst) sharing is a serialized burst on one
                    # lightpath (exchange stages), not a collision — the
                    # Eq.-3 accounting charges the step for the full burst
                    if owner is not None and owner != (tx.src, tx.dst):
                        raise AssertionError(
                            f"simulator: wavelength collision {key} between "
                            f"{owner} and {(tx.src, tx.dst)}")
                    wl_used[key] = (tx.src, tx.dst)
            for link in tx.links:
                load[(tx.direction, link)].add(tx.wavelength)
            arrivals[tx.dst].add(tx.item)
        if load:
            max_load = max(max_load, max(len(v) for v in load.values()))
        for dst, items in arrivals.items():
            holdings[dst] |= items
    if check:
        for p, h in enumerate(holdings):
            if exchange:
                need = {u * sched.n + p for u in range(sched.n)}
                missing = need - h
                assert not missing, (
                    f"simulator: node {p} missing {len(missing)} destination "
                    f"blocks (e.g. {sorted(missing)[:4]})")
            else:
                assert len(h) == sched.n, \
                    f"simulator: node {p} incomplete ({len(h)}/{sched.n})"
    # shared Eq.-3 accounting with the optical pricer (burst-aware): the
    # price==simulate invariant is literal — both call this helper
    _, stage_times, total, reconf = schedule_step_times(
        sched, sys, message_bytes, detailed=detailed)
    return SimReport(
        algorithm=str(sched.meta.get("algorithm", "?")),
        n=sched.n,
        w=sched.w,
        steps=len(steps),
        transmissions=len(sched.txs),
        time_s=total,
        max_link_load=max_load,
        stage_steps=tuple(sched.stage_steps),
        stage_times_s=stage_times,
        reconfigurations=reconf.events,
        reconfig_exposed_s=reconf.exposed_s,
    )
