"""Link/wavelength health: the degraded-hardware planning input.

Every other tier assumes the fabric it was priced against: the electrical
pricer assumes each axis link delivers its full ``LinkSpec`` bandwidth, the
Eq.-3/RWA backend assumes all ``w`` wavelengths of the ring are lit, and
the executor assumes every ppermute hop lands.  :class:`LinkHealth` makes
the *actual* hardware state a first-class value that planning, pricing,
lowering, validation, and the plan cache all consume:

  * per-(axis, direction) bandwidth **derating** in ``(0, 1]`` — a flaky
    transceiver at quarter speed is ``derate[("pod", CW)] = 0.25``;
  * **dead** (axis, direction) pairs — a cut fiber.  An axis with both
    directions dead cannot carry a staged collective at all
    (:class:`DeadAxisError`); a single dead direction prunes stage orders
    whose lowered schedule would cross it;
  * per-axis **lost-wavelength masks** — failed ring lasers / MRR columns.
    The WDM ring is a shared medium, so the effective wavelength count for
    a plan is ``w`` minus the union of losses over the plan's axes.

``LinkHealth`` is immutable; fault/recover events produce new tables via
:meth:`LinkHealth.apply`.  :meth:`LinkHealth.fingerprint` gives the short
stable hash the comms-context plan cache keys on (the "health fingerprint"
— a fault therefore *automatically* invalidates every cached plan priced
against the old world).  :class:`FaultTrace` is a deterministic, seeded
sequence of :class:`FaultEvent` for chaos-injection harnesses: the same
seed always reproduces the same fault schedule.

JSON round-trips reuse the ``load_links`` ``expect_axes`` idiom from
:mod:`repro.core.planner`: unknown axes are rejected with the same error
shape, and derates outside ``(0, 1]`` never load.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import random
from dataclasses import dataclass, field
from typing import (Dict, FrozenSet, Iterable, Mapping, Optional, Sequence,
                    Tuple)

__all__ = [
    "CW",
    "CCW",
    "DIRECTIONS",
    "HealthError",
    "DeadAxisError",
    "DeadDirectionError",
    "FaultEvent",
    "FaultTrace",
    "LinkHealth",
    "health_fingerprint",
    "load_health",
]

# mirrors core.schedule: direction 0 is clockwise (+1 neighbor), 1 is ccw
CW, CCW = 0, 1
DIRECTIONS = (CW, CCW)
_DIR_NAMES = {CW: "cw", CCW: "ccw"}


class HealthError(ValueError):
    """A plan cannot be produced under the current :class:`LinkHealth`."""


class DeadAxisError(HealthError):
    """Both directions of a required axis are dead — no staged plan can
    cross it; callers fall back to the one-shot XLA collective."""


class DeadDirectionError(HealthError):
    """Every stage-order candidate was pruned because its lowered schedule
    crosses a dead ring direction."""


def _check_direction(direction: int) -> int:
    if direction not in DIRECTIONS:
        raise ValueError(
            f"direction must be {CW} (cw) or {CCW} (ccw), got {direction!r}")
    return int(direction)


def _check_derate(value: float) -> float:
    value = float(value)
    if not (0.0 < value <= 1.0):
        raise ValueError(
            f"derate must be in (0, 1], got {value!r} "
            "(use kind='dead' for a fully failed direction)")
    return value


@dataclass(frozen=True)
class FaultEvent:
    """One fault or recovery, attributed to a training step.

    ``kind`` is one of:
      * ``"derate"``    — set ``derate`` for ``(axis, direction)``;
      * ``"dead"``      — mark ``(axis, direction)`` dead;
      * ``"lose_wavelength"`` — add ``wavelength`` to the axis's lost mask;
      * ``"recover"``   — clear state: the ``(axis, direction)`` entry when
        ``direction`` is given, the wavelength when ``wavelength`` is
        given, or everything recorded for ``axis`` when neither is.
    """

    step: int
    kind: str
    axis: str
    direction: Optional[int] = None
    derate: Optional[float] = None
    wavelength: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in ("derate", "dead", "lose_wavelength", "recover"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "derate":
            if self.derate is None:
                raise ValueError("kind='derate' requires a derate value")
            _check_derate(self.derate)
            _check_direction(self._dir())
        elif self.kind == "dead":
            _check_direction(self._dir())
        elif self.kind == "lose_wavelength":
            if self.wavelength is None or int(self.wavelength) < 0:
                raise ValueError(
                    "kind='lose_wavelength' requires wavelength >= 0")
        if self.direction is not None:
            _check_direction(self.direction)

    def _dir(self) -> int:
        return CW if self.direction is None else self.direction

    def describe(self) -> str:
        d = "" if self.direction is None else f"/{_DIR_NAMES[self.direction]}"
        extra = ""
        if self.kind == "derate":
            extra = f" x{self.derate:g}"
        elif self.kind == "lose_wavelength":
            extra = f" wl={self.wavelength}"
        return f"step {self.step}: {self.kind} {self.axis}{d}{extra}"


def _freeze_derate(m: Mapping[Tuple[str, int], float]
                   ) -> Tuple[Tuple[Tuple[str, int], float], ...]:
    out = []
    for (axis, direction), val in m.items():
        out.append(((str(axis), _check_direction(direction)),
                    _check_derate(val)))
    return tuple(sorted(out))


def _freeze_dead(s: Iterable[Tuple[str, int]]
                 ) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted(
        (str(axis), _check_direction(direction)) for axis, direction in s))


def _freeze_lost(m: Mapping[str, Iterable[int]]
                 ) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    out = []
    for axis, wls in m.items():
        wl_t = tuple(sorted({int(w) for w in wls}))
        if any(w < 0 for w in wl_t):
            raise ValueError(f"lost wavelength must be >= 0 on axis {axis!r}")
        if wl_t:
            out.append((str(axis), wl_t))
    return tuple(sorted(out))


@dataclass(frozen=True)
class LinkHealth:
    """Immutable health table.  Empty (the default) means fully healthy."""

    derate: Tuple[Tuple[Tuple[str, int], float], ...] = ()
    dead: Tuple[Tuple[str, int], ...] = ()
    lost_wavelengths: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()

    # ---------------------------------------------------------- constructors
    @staticmethod
    def healthy() -> "LinkHealth":
        return LinkHealth()

    @staticmethod
    def make(*,
             derate: Optional[Mapping[Tuple[str, int], float]] = None,
             dead: Optional[Iterable[Tuple[str, int]]] = None,
             lost_wavelengths: Optional[Mapping[str, Iterable[int]]] = None,
             ) -> "LinkHealth":
        return LinkHealth(
            derate=_freeze_derate(derate or {}),
            dead=_freeze_dead(dead or ()),
            lost_wavelengths=_freeze_lost(lost_wavelengths or {}),
        )

    def __post_init__(self) -> None:
        # normalize through the checked freezers so hand-built instances and
        # dataclasses.replace go through the same validation
        object.__setattr__(self, "derate", _freeze_derate(dict(self.derate)))
        object.__setattr__(self, "dead", _freeze_dead(self.dead))
        object.__setattr__(
            self, "lost_wavelengths",
            _freeze_lost({a: wls for a, wls in self.lost_wavelengths}))

    # --------------------------------------------------------------- queries
    @property
    def is_healthy(self) -> bool:
        return not (self.derate or self.dead or self.lost_wavelengths)

    def _derate_map(self) -> Dict[Tuple[str, int], float]:
        return dict(self.derate)

    def _dead_set(self) -> FrozenSet[Tuple[str, int]]:
        return frozenset(self.dead)

    def _lost_map(self) -> Dict[str, FrozenSet[int]]:
        return {a: frozenset(wls) for a, wls in self.lost_wavelengths}

    def axis_dead(self, axis: str) -> bool:
        dead = self._dead_set()
        return all((axis, d) in dead for d in DIRECTIONS)

    def axis_factor(self, axis: Optional[str]) -> float:
        """Best usable bandwidth fraction over the axis's alive directions
        (the planner routes around a single dead direction).  0.0 iff both
        directions are dead.  Unnamed axes (paper-world plans) are assumed
        healthy."""
        if axis is None:
            return 1.0
        dead, derate = self._dead_set(), self._derate_map()
        alive = [derate.get((axis, d), 1.0)
                 for d in DIRECTIONS if (axis, d) not in dead]
        return max(alive) if alive else 0.0

    def direction_factor(self, axis: str, direction: int) -> float:
        if (axis, direction) in self._dead_set():
            return 0.0
        return self._derate_map().get((axis, direction), 1.0)

    def dead_directions(self, axes: Optional[Sequence[Optional[str]]] = None
                        ) -> FrozenSet[int]:
        """Ring directions unusable for a plan spanning ``axes``: the union
        of dead directions over the named axes (the physical ring is
        shared).  ``axes=None`` — or any unnamed axis — unions over every
        axis in the table."""
        dead = self._dead_set()
        if axes is None or any(a is None for a in axes):
            return frozenset(d for _, d in dead)
        wanted = set(axes)
        return frozenset(d for a, d in dead if a in wanted)

    def lost_for(self, axes: Optional[Sequence[Optional[str]]] = None
                 ) -> FrozenSet[int]:
        """Lost-wavelength union for a plan spanning ``axes`` (shared WDM
        ring); ``axes=None`` or an unnamed axis unions everything."""
        lost = self._lost_map()
        if axes is None or any(a is None for a in axes):
            axes_iter: Iterable[str] = lost.keys()
        else:
            axes_iter = [a for a in axes if a in lost]
        out: FrozenSet[int] = frozenset()
        for a in axes_iter:
            out |= lost.get(a, frozenset())
        return out

    def degrade_link(self, axis: Optional[str], link):
        """LinkSpec with bandwidth scaled by :meth:`axis_factor`.  Raises
        :class:`DeadAxisError` when the axis has no alive direction."""
        f = self.axis_factor(axis)
        if f <= 0.0:
            raise DeadAxisError(
                f"axis {axis!r} is dead in both ring directions; no staged "
                "plan can cross it (fall back to the one-shot collective)")
        if f >= 1.0:
            return link
        return dataclasses.replace(
            link, bandwidth_bytes=link.bandwidth_bytes * f)

    def degrade_links(self, links: Mapping[str, object]) -> Dict[str, object]:
        return {a: self.degrade_link(a, l) for a, l in links.items()}

    # ---------------------------------------------------------------- events
    def apply(self, event: FaultEvent) -> "LinkHealth":
        derate, dead = self._derate_map(), set(self._dead_set())
        lost = {a: set(wls) for a, wls in self._lost_map().items()}
        key = (event.axis, event._dir())
        if event.kind == "derate":
            derate[key] = float(event.derate)
            dead.discard(key)
        elif event.kind == "dead":
            dead.add(key)
            derate.pop(key, None)
        elif event.kind == "lose_wavelength":
            lost.setdefault(event.axis, set()).add(int(event.wavelength))
        elif event.kind == "recover":
            if event.wavelength is not None:
                lost.get(event.axis, set()).discard(int(event.wavelength))
            elif event.direction is not None:
                derate.pop(key, None)
                dead.discard(key)
            else:
                for d in DIRECTIONS:
                    derate.pop((event.axis, d), None)
                    dead.discard((event.axis, d))
                lost.pop(event.axis, None)
        return LinkHealth.make(derate=derate, dead=dead,
                               lost_wavelengths=lost)

    # ----------------------------------------------------------- fingerprint
    def fingerprint(self) -> str:
        """Short stable id of the health state: ``"healthy"`` for the empty
        table, else 16 hex chars.  Goes into the plan-cache key so a fault
        invalidates every plan priced under the old world."""
        if self.is_healthy:
            return "healthy"
        canon = repr((self.derate, self.dead, self.lost_wavelengths))
        return hashlib.sha1(canon.encode()).hexdigest()[:16]

    def describe(self) -> str:
        if self.is_healthy:
            return "healthy"
        parts = []
        for (a, d), v in self.derate:
            parts.append(f"{a}/{_DIR_NAMES[d]} x{v:g}")
        for a, d in self.dead:
            parts.append(f"{a}/{_DIR_NAMES[d]} dead")
        for a, wls in self.lost_wavelengths:
            parts.append(f"{a} lost wl {list(wls)}")
        return "; ".join(parts)

    # ------------------------------------------------------------------ json
    def to_json(self) -> dict:
        return {
            "derate": [[a, _DIR_NAMES[d], v] for (a, d), v in self.derate],
            "dead": [[a, _DIR_NAMES[d]] for a, d in self.dead],
            "lost_wavelengths": {a: list(wls)
                                 for a, wls in self.lost_wavelengths},
        }

    @staticmethod
    def from_json(d: Mapping, *,
                  expect_axes: Optional[Sequence[str]] = None) -> "LinkHealth":
        """Inverse of :meth:`to_json` with validation.  ``expect_axes``
        follows the ``load_links`` idiom: every axis named by the table must
        be a known mesh axis (health is sparse, so *missing* axes are fine —
        they are simply healthy)."""
        if not isinstance(d, Mapping):
            raise ValueError(f"health table must be a mapping, got {type(d)}")
        unknown_keys = set(d) - {"derate", "dead", "lost_wavelengths"}
        if unknown_keys:
            raise ValueError(
                f"unknown health table keys {sorted(unknown_keys)}")
        dir_ids = {"cw": CW, "ccw": CCW, "0": CW, "1": CCW}

        def as_dir(v) -> int:
            if isinstance(v, str):
                if v not in dir_ids:
                    raise ValueError(
                        f"direction must be 'cw' or 'ccw', got {v!r}")
                return dir_ids[v]
            return _check_direction(int(v))

        derate: Dict[Tuple[str, int], float] = {}
        for entry in d.get("derate", []):
            axis, direction, val = entry
            derate[(str(axis), as_dir(direction))] = _check_derate(val)
        dead = {(str(a), as_dir(dd)) for a, dd in d.get("dead", [])}
        lost = {str(a): [int(w) for w in wls]
                for a, wls in d.get("lost_wavelengths", {}).items()}
        health = LinkHealth.make(derate=derate, dead=dead,
                                 lost_wavelengths=lost)
        if expect_axes is not None:
            expect = set(expect_axes)
            named = ({a for (a, _), _ in health.derate}
                     | {a for a, _ in health.dead}
                     | {a for a, _ in health.lost_wavelengths})
            unknown = sorted(named - expect)
            if unknown:
                raise ValueError(
                    f"health table does not match axes {sorted(expect)}: "
                    f"unknown axes {unknown}")
        return health


def health_fingerprint(health: Optional[LinkHealth]) -> str:
    """Cache-key fingerprint; ``None`` is the healthy world."""
    return "healthy" if health is None else health.fingerprint()


def load_health(path, *,
                expect_axes: Optional[Sequence[str]] = None) -> LinkHealth:
    """Read a :meth:`LinkHealth.to_json` file from disk."""
    with open(path) as f:
        return LinkHealth.from_json(json.load(f), expect_axes=expect_axes)


@dataclass(frozen=True)
class FaultTrace:
    """A deterministic fault schedule: ``events`` ordered by step.

    :meth:`generate` derives the whole trace from a seed via
    ``random.Random(seed)`` — no global RNG, so the same seed reproduces
    the identical fault/recover sequence in every process of a chaos run.
    """

    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: e.step)))

    @staticmethod
    def generate(axes: Sequence[str], steps: int, *, seed: int,
                 rate: float = 0.1, wavelengths: int = 64,
                 allow_dead: bool = False,
                 recover_after: int = 2) -> "FaultTrace":
        """Seeded trace: each step faults with probability ``rate``; a
        matching recovery is scheduled ``recover_after`` steps later (so
        traces exercise both directions of the cache-invalidation path).
        ``allow_dead`` adds whole-direction kills to the event mix."""
        rng = random.Random(seed)
        kinds = ["derate", "derate", "lose_wavelength"]
        if allow_dead:
            kinds.append("dead")
        events = []
        for step in range(steps):
            if rng.random() >= rate:
                continue
            axis = rng.choice(list(axes))
            kind = rng.choice(kinds)
            if kind == "derate":
                ev = FaultEvent(step, "derate", axis,
                                direction=rng.choice(DIRECTIONS),
                                derate=rng.choice([0.25, 0.5, 0.75]))
                rec = FaultEvent(step + recover_after, "recover", axis,
                                 direction=ev.direction)
            elif kind == "lose_wavelength":
                wl = rng.randrange(wavelengths)
                ev = FaultEvent(step, "lose_wavelength", axis, wavelength=wl)
                rec = FaultEvent(step + recover_after, "recover", axis,
                                 wavelength=wl)
            else:
                ev = FaultEvent(step, "dead", axis,
                                direction=rng.choice(DIRECTIONS))
                rec = FaultEvent(step + recover_after, "recover", axis,
                                 direction=ev.direction)
            events.append(ev)
            events.append(rec)
        return FaultTrace(events=tuple(events), seed=seed)

    def at(self, step: int) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def apply_step(self, health: LinkHealth, step: int) -> LinkHealth:
        for ev in self.at(step):
            health = health.apply(ev)
        return health

    def replay(self, step: int) -> LinkHealth:
        """Health table after folding every event with ``event.step <=
        step`` into the healthy world."""
        health = LinkHealth()
        for ev in self.events:
            if ev.step <= step:
                health = health.apply(ev)
        return health
