"""Schedule validators: the correctness oracle for every schedule builder.

A schedule is *valid* iff:
  1. conflict-freedom — within a step, no two lightpaths share a
     (direction, link) on the same wavelength, and wavelength < w.  The
     one sanctioned sharing is a same-pair BURST: transmissions between
     the same (src, dst) may ride one wavelength together (exchange
     stages serialize a pair's items over a single lightpath — the cost
     model charges the step for the whole burst);
  2. causality — a node only transmits items it holds when the step begins;
  3. completeness — afterwards every node holds its collective's target set.
  4. health (optional) — no transmission rides a lost wavelength or a dead
     ring direction of the :class:`~repro_torch.core.health.LinkHealth` it is
     checked against (``schedule_from_ir(..., health=...)`` schedules
     *around* faults; this check is the defense in depth that catches a
     builder that does not).

``sched.meta["semantics"]`` selects the item model, exactly as in
``optics.simulator``: ``"gather"`` (the default) starts node i holding
item i and requires every node to end with all n items; ``"exchange"``
(a2a) uses the n² (origin, destination) item space ``u·n + v`` — node u
starts holding ``{u·n + v : v}`` and node v must end holding ``{u·n + v :
u}``.

These checks are what the hypothesis property tests sweep.  Error messages
name the offending (step, link, wavelength, health state) so a failed
chaos run points straight at the bad transmission.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set, Tuple

from .schedule import Schedule, Tx

__all__ = [
    "validate_conflict_free",
    "validate_causality_completeness",
    "validate_health",
    "validate_schedule",
]

_DIR_NAMES = {0: "cw", 1: "ccw"}


class ScheduleError(AssertionError):
    pass


def _tx_where(tx: Tx) -> str:
    return (f"step {tx.step}, {tx.src}->{tx.dst} "
            f"dir={_DIR_NAMES.get(tx.direction, tx.direction)} "
            f"wl={tx.wavelength} links={list(tx.links)}")


def validate_conflict_free(sched: Schedule) -> None:
    for step_txs in sched.by_step():
        seen: Dict[Tuple[int, int, int], Tx] = {}
        for tx in step_txs:
            if not (0 <= tx.wavelength < sched.w):
                raise ScheduleError(
                    f"wavelength {tx.wavelength} out of range w={sched.w} "
                    f"at {_tx_where(tx)}"
                )
            for link in tx.links:
                key = (tx.direction, link, tx.wavelength)
                if key in seen:
                    other = seen[key]
                    # same-pair burst: one lightpath serializing several
                    # items between one (src, dst) is not a conflict
                    if (other.src, other.dst) == (tx.src, tx.dst):
                        continue
                    raise ScheduleError(
                        f"wavelength conflict at step {tx.step}: link {link} "
                        f"(dir={_DIR_NAMES.get(tx.direction, tx.direction)}, "
                        f"wl={tx.wavelength}) carried by both "
                        f"{other.src}->{other.dst} (item {other.item}) and "
                        f"{tx.src}->{tx.dst} (item {tx.item})"
                    )
                seen[key] = tx


def validate_causality_completeness(sched: Schedule) -> None:
    exchange = sched.meta.get("semantics") == "exchange"
    if exchange:
        holdings: List[Set[int]] = [
            {u * sched.n + v for v in range(sched.n)} for u in range(sched.n)
        ]
    else:
        holdings = [{i} for i in range(sched.n)]
    for step_txs in sched.by_step():
        arrivals: Dict[int, Set[int]] = defaultdict(set)
        for tx in step_txs:
            if tx.item not in holdings[tx.src]:
                raise ScheduleError(
                    f"causality violation at {_tx_where(tx)}: node {tx.src} "
                    f"sends item {tx.item} it does not hold when the step "
                    f"begins (holds {len(holdings[tx.src])} items)"
                )
            arrivals[tx.dst].add(tx.item)
        for dst, items in arrivals.items():
            holdings[dst] |= items
    for p, h in enumerate(holdings):
        need = ({u * sched.n + p for u in range(sched.n)} if exchange
                else set(range(sched.n)))
        missing = sorted(need - h)
        if missing:
            raise ScheduleError(
                f"incomplete {'all-to-all' if exchange else 'all-gather'}: "
                f"node {p} missing items {missing[:8]}"
                f"{'...' if len(missing) > 8 else ''}"
            )


def validate_health(sched: Schedule, health) -> None:
    """Reject any transmission on a lost wavelength or a dead ring
    direction of ``health``.  The axis scope comes from
    ``sched.meta["axes"]`` (stamped by ``schedule_from_ir``); schedules
    without it are checked against the union over the whole health table —
    the conservative reading of a shared ring."""
    if health is None or health.is_healthy:
        return
    axes = sched.meta.get("axes")
    lost = health.lost_for(axes)
    dead = health.dead_directions(axes)
    for tx in sched.txs:
        if tx.wavelength in lost:
            raise ScheduleError(
                f"transmission on LOST wavelength at {_tx_where(tx)}: "
                f"health says wavelengths {sorted(lost)} are down for axes "
                f"{list(axes) if axes else '<all>'} ({health.describe()})"
            )
        if tx.direction in dead:
            raise ScheduleError(
                f"transmission on DEAD ring direction at {_tx_where(tx)}: "
                f"health says direction "
                f"{_DIR_NAMES.get(tx.direction, tx.direction)} is dead for "
                f"axes {list(axes) if axes else '<all>'} "
                f"({health.describe()})"
            )


def validate_schedule(sched: Schedule,
                      health=None) -> None:
    validate_conflict_free(sched)
    validate_causality_completeness(sched)
    if health is not None:
        validate_health(sched, health)
