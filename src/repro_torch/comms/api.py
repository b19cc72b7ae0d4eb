"""Context-scoped collectives API: ONE entry surface for every
gather-shaped collective.

Install a :class:`CommContext` once, call the module-level ops anywhere:

    mesh = FactorizedMesh([2, 4], ("pod", "tp"))    # after init_world
    with comm_context(mesh, ("pod", "tp")) as ctx:
        y = api.all_reduce(x)                        # x: this rank's array

Every op dispatches through ``plan_collectives`` -> the unified
:class:`~repro_torch.core.plan_ir.CollectivePlan` IR -> ``execute_plan``;
the POLICY (mode / chunking / fusion / stage-order overrides) lives on the
context (:class:`PlanPolicy`), not at call sites.

Plans are cached per context, keyed
``(collective, shape, dtype, axes, policy, links_fingerprint)``.  The
links fingerprint makes the cache **auto-invalidating**: feeding a new
links table back (``ctx.update_links(...)``) drops every stale entry and
the next call re-plans with it.  ``ctx.cache_stats`` (hits / misses /
invalidated) makes the re-plan observable.

A plain tensor is this rank's LOCAL array: the reference's "inside
shard_map" contract, one process per rank.  A DTensor is a global array,
the reference's call outside ``shard_map``: the op redistributes it to the
reference's ``in_spec`` over the context's axes (all_gather: sharded along
``axis``; reduce_scatter and all_reduce: replicated; all_to_all: sharded),
runs the plan on ``to_local()`` exactly as on a local array, and returns
``DTensor.from_local`` at the ``out_spec`` (all_gather and all_reduce:
replicated; reduce_scatter and all_to_all: sharded along ``axis``), of the
input's global shape.  The DTensor's mesh names its dims by the context's
axis names, rank for rank as the context's ``FactorizedMesh``.  Under
``PlanPolicy(verify=True)`` every op runs through the verified executor
(``plan_executor.execute_plan_verified``: checksums, bounded retry, the
one-shot fallback), and a fallback on any rank of the group is counted
once in ``cache_stats.fallbacks`` on every rank.

The fused collective-matmul ops (``allgather_matmul``,
``matmul_reduce_scatter``) decide per call, through
``CommContext.decide_fuse``, between the fused rings of
``comms.collective_matmul`` and the planned collective beside a plain
matmul.  Every op is differentiable, as the reference's are under
``jax.grad``: under grad mode the backward of a planned collective is its
dual collective (AG and RS each other's, AR and a2a their own), planned
by the same context, and the fused ops carry their own dual rings.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.health import (
    FaultEvent,
    HealthError,
    LinkHealth,
    health_fingerprint,
    load_health,
)
from ..core.plan_ir import CollectivePlan
from ..core.planner import (
    LinkSpec,
    load_links,
    matmul_block_time,
    plan_collective_matmul,
)
from ..tree import is_dtensor
from .collective_matmul import _mm, fused_allgather_matmul, fused_matmul_reduce_scatter

__all__ = [
    "PlanPolicy",
    "CacheStats",
    "CommContext",
    "comm_context",
    "current_context",
    "use_context",
    "legacy_chunks",
    "links_fingerprint",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "all_to_all",
    "allgather_matmul",
    "matmul_reduce_scatter",
]


# --------------------------------------------------------------------------
# policy + context
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanPolicy:
    """Per-context planning/execution overrides.

    ``mode``       — force the plan-level execution mode (``oneshot`` /
                     ``chunked`` / ``perhop`` / ``hybrid``); None follows
                     the planner.
    ``num_chunks`` — force the wavefront chunk count (implies ``chunked``
                     when > 1, unless the plan already runs a chunked-
                     family mode — a hybrid plan keeps its ring stages);
                     None follows the planner.
    ``max_chunks`` — planner search bound for the chunk decision.
    ``fuse``       — collective-matmul fusion: True / False / ``"auto"``
                     (the ``plan_collective_matmul`` overlap model decides
                     per (shape, mesh) point).
    ``order``      — the stage-order hook (cross-world planning):
                       * ``None`` — the electrical cost-model planners pick
                         the order directly (slow-axis-first AG, reversed
                         RS), no search;
                       * ``"electrical"`` / ``"optical"`` —
                         ``core.planner.search_stage_orders`` enumerates
                         candidate orders, prices every candidate plan
                         under BOTH backends, and the named backend's
                         winner is cached per context key — ``"optical"``
                         makes the paper's Eq.-3 RWA pricing drive the
                         engine's stage order;
                       * an explicit axis-name tuple — force exactly this
                         all-gather order (RS runs its reverse, AR the
                         RS-order + reversed).
    ``optical``    — the ``OpticalSystem`` the ``"optical"`` search prices
                     with (None = TERARACK defaults); lower wavelength
                     counts sharpen order differences (step counts tie at
                     large w on small meshes).
    ``verify``     — run ops through ``execute_plan_verified``: per-stage
                     conservation checksums, up to ``verify_retries``
                     bounded retries of the staged path, then a graceful
                     degrade to the bit-identical one-shot collective
                     (counted in ``CacheStats.fallbacks``).
    ``verify_retries`` — retry budget for the verified executor (>= 0).
    ``regime``     — the latency/bandwidth plan family:
                       * ``"auto"`` (default) — per payload size, price the
                         recursive-doubling exchange chain
                         (``plan_latency_collective``) against the ring
                         plan and cache the electrical winner — decode-size
                         psums get log-round latency plans, training
                         payloads keep their ring/hybrid modes;
                       * ``"bandwidth"`` — rings only;
                       * ``"latency"`` — force the exchange chain; raises
                         when the axis structure has no latency plan
                         (non-power-of-two sizes).
                     Latency plans are single-shot exchange chains, so
                     ``regime="latency"`` is incompatible with ``mode``/
                     ``num_chunks``/``order`` overrides, and any mode or
                     chunk override (policy or per-call) pins the plan to
                     the bandwidth family.
    ``reconfig``   — the hold-vs-reconfigure constraint on a
                     reconfigurable photonic fabric:
                       * ``"auto"`` (default) — the order search ranks the
                         full candidate space; the per-event
                         ``OpticalSystem.circuit_reconfig_s`` delay (minus
                         SWOT overlap) is part of every candidate's
                         optical price, so the ranking decides;
                       * ``"hold"`` — only candidates that keep ONE
                         circuit for the whole collective;
                       * ``"reconfigure"`` — only candidates that pay at
                         least one topology change.
                     Only meaningful on the searched-order path, so a
                     non-auto value requires ``order`` to be
                     ``"electrical"`` or ``"optical"``.
    """

    mode: Optional[str] = None
    num_chunks: Optional[int] = None
    max_chunks: int = 8
    fuse: object = "auto"
    order: object = None
    optical: object = None
    verify: bool = False
    verify_retries: int = 1
    regime: str = "auto"
    reconfig: str = "auto"

    def __post_init__(self):
        if self.mode is not None and self.mode not in (
                "oneshot", "chunked", "perhop", "hybrid"):
            raise ValueError(f"policy mode must be oneshot|chunked|perhop|"
                             f"hybrid, got {self.mode!r}")
        if self.regime not in ("auto", "latency", "bandwidth"):
            raise ValueError(f"policy regime must be auto|latency|bandwidth, "
                             f"got {self.regime!r}")
        if self.regime == "latency" and (
                self.mode is not None or self.num_chunks is not None
                or self.order is not None):
            raise ValueError(
                "regime='latency' forces single-shot exchange plans; "
                "mode/num_chunks/order overrides are incompatible with it")
        if self.reconfig not in ("auto", "hold", "reconfigure"):
            raise ValueError(
                f"policy reconfig must be auto|hold|reconfigure, "
                f"got {self.reconfig!r}")
        if self.reconfig != "auto" and self.order not in (
                "electrical", "optical"):
            raise ValueError(
                f"reconfig={self.reconfig!r} only constrains the searched-"
                f"order path; it requires order='electrical' or 'optical', "
                f"got order={self.order!r}")
        if not isinstance(self.verify_retries, int) or self.verify_retries < 0:
            raise ValueError(
                f"verify_retries must be a non-negative int, "
                f"got {self.verify_retries!r}")
        if isinstance(self.order, str):
            if self.order not in ("electrical", "optical"):
                raise ValueError(
                    f"policy order must be 'electrical', 'optical' or an "
                    f"axis-name tuple, got {self.order!r}")
        elif self.order is not None:
            object.__setattr__(self, "order", tuple(self.order))

    def merged(self, **overrides) -> "PlanPolicy":
        """A copy with the given fields replaced (nesting semantics)."""
        return dataclasses.replace(self, **overrides)


@dataclass
class CacheStats:
    """Plan-cache counters.

    ``invalidated`` counts entries dropped by a links-table change
    (``CommContext.update_links``) or a health change;
    ``replans_on_fault`` counts entries re-planned IN PLACE after a
    ``report_fault``/``update_health`` (the self-healing path);
    ``fallbacks`` counts degrades to the one-shot collective — either at
    plan time (a dead axis/direction made every staged candidate illegal)
    or at run time (the verified executor exhausted its retries);
    ``latency_plans`` / ``ring_plans`` split the planned entries by regime
    (exchange chains vs ring/hybrid stages) — the per-size winner cache
    made observable."""

    hits: int = 0
    misses: int = 0
    invalidated: int = 0
    replans_on_fault: int = 0
    fallbacks: int = 0
    latency_plans: int = 0
    ring_plans: int = 0

    def to_json(self) -> Dict[str, int]:
        """The counters as one structured dict — callers (train telemetry,
        the cluster front end's drain report) log this blob instead of
        hand-formatting fields."""
        return dataclasses.asdict(self)


def links_fingerprint(links: Optional[Dict[str, LinkSpec]]) -> str:
    """Stable fingerprint of an axis→LinkSpec table — part of every plan
    cache key, so swapping the table re-keys (invalidates) every plan."""
    if not links:
        return "default"
    items = sorted(
        (a, l.name, float(l.bandwidth_bytes), float(l.alpha_s))
        for a, l in links.items()
    )
    return hashlib.sha1(repr(items).encode()).hexdigest()[:16]


class CommContext:
    """One mesh + axis set + LinkSpec table + policy = one collectives
    scope.  All module-level ops resolve to the innermost installed context
    (or an explicit ``ctx=`` handle) and share its plan cache.

    ``mesh`` is a :class:`~repro_torch.comms.mesh_utils.FactorizedMesh`,
    or None for a planning-only context (the ops need a mesh to run).
    ``axis_sizes`` overrides size lookup for meshless planning (tests /
    offline planning).
    """

    def __init__(
        self,
        mesh=None,
        axis_names: Optional[Sequence[str]] = None,
        *,
        links: Optional[Dict[str, LinkSpec]] = None,
        policy: Optional[PlanPolicy] = None,
        axis_sizes: Optional[Dict[str, int]] = None,
        health: Optional[LinkHealth] = None,
    ):
        self.mesh = mesh
        self.axis_names = tuple(axis_names) if axis_names is not None else None
        self.links = dict(links) if links else None
        self.policy = policy or PlanPolicy()
        self.axis_sizes = dict(axis_sizes) if axis_sizes else None
        self.health = health
        self._links_fp = links_fingerprint(self.links)
        self._health_fp = health_fingerprint(health)
        self._cache: Dict[tuple, CollectivePlan] = {}
        self._counts: Dict[tuple, int] = {}
        # what each cache entry was planned FOR — lets a health change
        # re-plan every live entry in place instead of just dropping it
        self._requests: Dict[tuple, tuple] = {}
        # memoized latency/bandwidth crossover payloads, keyed
        # (collective, names, links_fp, health_fp) — telemetry only
        self._crossovers: Dict[tuple, Optional[float]] = {}
        self.cache_stats = CacheStats()

    # -- links / auto-calibration -----------------------------------------
    def update_links(self, links: Union[str, Dict[str, LinkSpec]],
                     *, merge: bool = True) -> Dict[str, LinkSpec]:
        """Swap (or merge into) the LinkSpec table and invalidate every
        cached plan — the auto-calibration path: point this at a
        ``launch/perf.py --calibrate`` output and the very next op call
        re-plans with the fitted specs, same context, same cache.
        """
        if isinstance(links, (str,)) or hasattr(links, "read_text"):
            expect = self.axis_names
            links = load_links(links, fallbacks=self.links,
                               expect_axes=expect, allow_missing=True)
        table = dict(self.links) if (merge and self.links) else {}
        table.update(links)
        self.links = table
        new_fp = links_fingerprint(self.links)
        if new_fp != self._links_fp:
            self.cache_stats.invalidated += len(self._cache)
            self._cache.clear()
            self._counts.clear()
            self._requests.clear()
            self._links_fp = new_fp
        return self.links

    @property
    def links_fp(self) -> str:
        return self._links_fp

    # -- health / fault handling -------------------------------------------
    def update_health(self, health: Union[str, LinkHealth, None]) -> Optional[LinkHealth]:
        """Swap the link/wavelength health table (a :class:`LinkHealth`, a
        JSON path, or None = fully healthy) and RE-PLAN every cached entry
        in place under the new degraded world — the self-healing path:
        callers keep calling the same ops, and the very next hit serves a
        plan already priced (and order-searched) for the faulted fabric.
        A planning dead end (dead axis / every order crossing a dead
        direction) degrades that entry to the one-shot fallback plan,
        counted in ``cache_stats.fallbacks``."""
        if isinstance(health, (str,)) or hasattr(health, "read_text"):
            health = load_health(health, expect_axes=self.axis_names)
        new_fp = health_fingerprint(health)
        self.health = health
        if new_fp != self._health_fp:
            self._health_fp = new_fp
            self._replan_cached()
        return self.health

    def report_fault(
        self,
        event: Optional[FaultEvent] = None,
        *,
        axis: Optional[str] = None,
        kind: Optional[str] = None,
        direction: Optional[int] = None,
        derate: Optional[float] = None,
        wavelength: Optional[int] = None,
        step: int = 0,
    ) -> Optional[LinkHealth]:
        """Fold one fault (or recovery) event into the health table and
        re-plan affected cache entries in place.  Pass a
        :class:`~repro_torch.core.health.FaultEvent`, or keyword pieces —
        ``kind`` is inferred when omitted (``wavelength=`` →
        ``lose_wavelength``, ``derate=`` → ``derate``, else ``dead``)."""
        if event is None:
            if axis is None:
                raise ValueError(
                    "report_fault needs a FaultEvent or axis=... pieces")
            if kind is None:
                kind = ("lose_wavelength" if wavelength is not None
                        else "derate" if derate is not None else "dead")
            event = FaultEvent(step=step, kind=kind, axis=axis,
                               direction=direction, derate=derate,
                               wavelength=wavelength)
        base = self.health if self.health is not None else LinkHealth()
        return self.update_health(base.apply(event))

    def _replan_cached(self):
        """Re-key and re-plan every cached entry under the current health
        fingerprint.  Old keys are invalidated (counted), each live request
        is planned afresh — ``cache_stats.replans_on_fault`` counts them —
        and usage counts carry over so telemetry stays meaningful."""
        stale = list(self._cache)
        self.cache_stats.invalidated += len(stale)
        old_counts, old_requests = self._counts, self._requests
        self._cache, self._counts, self._requests = {}, {}, {}
        for old_key in stale:
            req = old_requests.get(old_key)
            if req is None:
                continue
            new_key = old_key[:-1] + (self._health_fp,)
            self._cache[new_key] = self._plan_with_fallback(*req)
            self._requests[new_key] = req
            self._counts[new_key] = old_counts.get(old_key, 0)
            self.cache_stats.replans_on_fault += 1

    @property
    def health_fp(self) -> str:
        return self._health_fp

    def plans(self) -> List[CollectivePlan]:
        """Snapshot of every cached CollectivePlan — the same objects the
        ops execute, priceable (``core.cost_model.price``) and lowerable to
        the optical simulator (``core.schedule.schedule_from_ir``)."""
        return list(self._cache.values())

    def plan_usage(self) -> List[Tuple[CollectivePlan, int]]:
        """(plan, times-requested) pairs — distinguishes the deduplicated
        cache entries from how often each was actually issued (e.g. a TP
        block's two all-reduces share one entry but count twice)."""
        return [(p, self._counts.get(k, 0)) for k, p in self._cache.items()]

    def telemetry_snapshot(self) -> Dict:
        """One structured telemetry blob for this context: cache counters
        (:meth:`CacheStats.to_json`), fingerprints, the regime crossover,
        and a per-cached-plan record (collective, payload, mode/chunks,
        stage order, regime, issue count, order-search verdict, fallback
        reason), one dict a caller logs as JSON."""
        plans = []
        for plan, issued in self.plan_usage():
            rec = {
                "collective": plan.collective,
                "shard_bytes": float(plan.shard_bytes),
                "regime": plan.meta.get("regime", "bandwidth"),
                "mode": plan.mode,
                "num_chunks": plan.num_chunks,
                "order": [str(a) for a in plan.axes],
                "issued": issued,
            }
            srch = plan.meta.get("order_search")
            if srch:
                rec["order_search"] = {
                    "backend": srch["backend"],
                    "flipped": srch["flipped"],
                    "regime_flipped": srch.get("regime_flipped", False),
                    "reconfigurations": srch.get("reconfigurations", 0),
                }
            if plan.meta.get("fallback"):
                rec["fallback"] = plan.meta["fallback"]
            plans.append(rec)
        xover = (self.latency_crossover("ar")
                 if self.axis_names else None)
        return {
            "plans": len(self._cache),
            "cache": self.cache_stats.to_json(),
            "links_fp": self._links_fp,
            "health_fp": self._health_fp,
            "crossover_ar_bytes": xover,
            "per_plan": plans,
        }

    # -- sizes -------------------------------------------------------------
    def _names(self, axes: Optional[Sequence[str]]) -> Tuple[str, ...]:
        names = tuple(axes) if axes is not None else self.axis_names
        if not names:
            raise ValueError(
                "no collective axes: pass axes=... or install a context "
                "with axis_names (comm_context(mesh, names))")
        return names

    def _sizes(self, names: Tuple[str, ...]) -> Dict[str, int]:
        if self.axis_sizes is not None:
            known = {n: self.axis_sizes[n] for n in names if n in self.axis_sizes}
            if len(known) == len(names):
                return known
        if self.mesh is not None:
            return {n: self.mesh.shape[n] for n in names}
        raise ValueError(
            f"no sizes for axes {names}: the context has no mesh and its "
            f"axis_sizes do not name them all")

    # -- planning (cached) ---------------------------------------------------
    def _effective_regime(self, mode: Optional[str] = None,
                          num_chunks: Optional[int] = None) -> str:
        """The regime one op call actually plans under: any mode/chunk
        override — per-call or policy-level — pins the plan to the
        bandwidth family (latency plans are single-shot exchange chains
        with no chunked/perhop execution to force)."""
        pol = self.policy
        if mode is not None or num_chunks is not None:
            if pol.regime == "latency":
                raise ValueError(
                    "regime='latency' plans are single-shot exchange "
                    "chains; per-call mode/num_chunks overrides do not "
                    "apply — use regime='auto' or 'bandwidth'")
            return "bandwidth"
        if pol.mode is not None or pol.num_chunks is not None:
            return "bandwidth"
        return pol.regime

    def plan(
        self,
        collective: str,
        shard_bytes: float,
        *,
        axes: Optional[Sequence[str]] = None,
        shape: Optional[Tuple[int, ...]] = None,
        dtype=None,
        regime: Optional[str] = None,
    ) -> CollectivePlan:
        """The policy-resolved CollectivePlan for one (collective, payload)
        point.  ``shard_bytes`` is the scattered-end payload, as everywhere
        in the planner (for "a2a": the full local exchange buffer — all N
        destination blocks).  Cached on ``(collective, shape, dtype, axes,
        regime, policy, links_fingerprint)``; a links change re-keys
        everything.  ``regime`` overrides the policy regime for this call
        (the ops pass ``_effective_regime`` so a per-call mode/chunk
        override plans in the bandwidth family).
        """
        if collective not in ("ag", "rs", "ar", "a2a"):
            raise ValueError(
                f"collective must be ag|rs|ar|a2a, got {collective!r}")
        regime = regime if regime is not None else self._effective_regime()
        names = self._names(axes)
        sizes = self._sizes(names)
        # shard_bytes AND the resolved axis sizes are always part of the
        # key: the same (shape, dtype) can be an AG shard or an RS addend,
        # and the same axis NAME can have a different size on another mesh
        # (the shared default context sees many): either collision would
        # serve a stale plan
        key = (
            collective,
            float(shard_bytes),
            tuple(sizes[n] for n in names),
            tuple(shape) if shape is not None else None,
            str(dtype) if dtype is not None else None,
            names,
            regime,
            self.policy,
            self._links_fp,
            self._health_fp,  # LAST: _replan_cached re-keys on it
        )
        self._counts[key] = self._counts.get(key, 0) + 1
        cached = self._cache.get(key)
        if cached is not None:
            self.cache_stats.hits += 1
            return cached
        self.cache_stats.misses += 1
        plan = self._plan_with_fallback(
            collective, float(shard_bytes), names, sizes, regime)
        self._cache[key] = plan
        self._requests[key] = (
            collective, float(shard_bytes), names, sizes, regime)
        return plan

    def _plan_with_fallback(
        self, collective: str, shard_bytes: float, names: Tuple[str, ...],
        sizes: Dict[str, int], regime: str = "auto",
    ) -> CollectivePlan:
        """Plan under the current health; when the degraded world makes
        every staged candidate illegal (dead axis, or every stage order
        crossing a dead ring direction), degrade gracefully to the one-shot
        fallback plan instead of failing the op."""
        try:
            plan = self._plan_uncached(
                collective, shard_bytes, names, sizes, regime)
        except HealthError as err:
            plan = self._fallback_plan(
                collective, shard_bytes, names, sizes, str(err))
            self.cache_stats.fallbacks += 1
        if self._health_fp != "healthy":
            plan = dataclasses.replace(
                plan, meta={**plan.meta, "health_fp": self._health_fp})
        if any(s.mode == "exchange" for s in plan.stages):
            self.cache_stats.latency_plans += 1
        else:
            self.cache_stats.ring_plans += 1
        return plan

    def latency_crossover(
        self, collective: str = "ar",
        axes: Optional[Sequence[str]] = None,
    ) -> Optional[float]:
        """The electrical crossover payload (bytes) below which the latency
        (recursive-doubling) plan beats every ring mode on these axes —
        memoized per (collective, axes, links, health); None when the axis
        structure has no latency plan (non-power-of-two sizes or a dead
        ring direction).  Telemetry for the per-size winner cache."""
        names = self._names(axes)
        key = (collective, names, self._links_fp, self._health_fp)
        if key not in self._crossovers:
            from ..core.planner import latency_crossover_bytes
            from .staged_allgather import link_for_axis

            sizes = self._sizes(names)
            health = self.health
            if health is not None and health.is_healthy:
                health = None
            axes_l = [(n, sizes[n], link_for_axis(n, self.links))
                      for n in names]
            self._crossovers[key] = latency_crossover_bytes(
                axes_l, collective=collective, health=health)
        return self._crossovers[key]

    def _fallback_plan(self, collective, shard_bytes, names, sizes, reason):
        """The graceful-degrade plan: every stage one-shot (blocking
        collectives, bit-identical results, no staged ring traffic over the
        faulted fabric), with the reason recorded for telemetry."""
        from .staged_collectives import plan_collectives  # lazy: cycle

        plan = plan_collectives(
            sizes, names, shard_bytes, links=self.links,
            max_chunks=self.policy.max_chunks,
        )[collective].with_mode("oneshot")
        return dataclasses.replace(
            plan, meta={**plan.meta, "fallback": reason})

    def _plan_uncached(
        self, collective: str, shard_bytes: float, names: Tuple[str, ...],
        sizes: Dict[str, int], regime: str = "auto",
    ) -> CollectivePlan:
        from .staged_collectives import plan_collectives  # lazy: cycle

        pol = self.policy
        health = self.health
        if health is not None and health.is_healthy:
            health = None
        if regime == "latency":
            # forced family: the exchange-chain permutation is chosen by
            # its own closed-form cost — no ring order search applies
            plan = self._pick_regime(
                None, collective, shard_bytes, names, sizes, health, regime)
        elif pol.order in ("electrical", "optical"):
            plan = self._plan_searched_order(
                collective, shard_bytes, names, sizes, health,
                include_latency=(regime != "bandwidth"))
        elif pol.order is not None:
            plan = self._plan_forced_order(
                collective, shard_bytes, names, sizes, health)
        else:
            links = self.links
            if health is not None:
                from .staged_allgather import link_for_axis
                # plan under the DEGRADED world: each axis's link scaled by
                # its best alive direction (a fully dead axis raises
                # DeadAxisError → _plan_with_fallback builds the one-shot
                # fallback plan)
                links = {
                    n: health.degrade_link(n, link_for_axis(n, self.links))
                    for n in names}
            plan = plan_collectives(
                sizes, names, shard_bytes, links=links,
                max_chunks=pol.max_chunks,
            )[collective]
            plan = self._pick_regime(
                plan, collective, shard_bytes, names, sizes, health, regime)
        plan = _apply_overrides(plan, pol.mode, pol.num_chunks)
        is_latency = any(s.mode == "exchange" for s in plan.stages)
        return dataclasses.replace(
            plan, meta={**plan.meta,
                        "regime": "latency" if is_latency else "bandwidth"})

    def _pick_regime(self, ring_plan, collective, shard_bytes, names, sizes,
                     health, regime):
        """The per-size regime decision on the default (no order search)
        planning path: price the recursive-doubling exchange chain against
        the planner's ring plan under the electrical backend and keep the
        winner (``regime="auto"``), or force the exchange chain
        (``regime="latency"`` — an error when the structure has none)."""
        if collective not in ("ag", "rs", "ar"):
            if regime == "latency":
                raise ValueError(
                    f"regime='latency' has no {collective} plans (exchange "
                    f"chains exist for ag/rs/ar only)")
            return ring_plan
        if regime == "bandwidth":
            return ring_plan
        from ..core.cost_model import price
        from ..core.planner import plan_latency_collective
        from .staged_allgather import link_for_axis

        axes_l = [(n, sizes[n], link_for_axis(n, self.links)) for n in names]
        lat = plan_latency_collective(
            axes_l, shard_bytes, collective=collective, health=health)
        if lat is None:
            if regime == "latency":
                if health is not None and health.dead_directions(names):
                    # a dead ring direction, not a structural mismatch:
                    # degrade to the one-shot fallback like any other
                    # planning dead end under faults
                    raise HealthError(
                        f"latency plan for {collective} needs both ring "
                        f"directions alive on axes {names}")
                raise ValueError(
                    f"regime='latency': no recursive-doubling plan for "
                    f"{collective} on axes {dict(sizes)} (sizes must be "
                    f"powers of two)")
            return ring_plan
        if regime == "latency":
            return lat
        return lat if price(lat).total_s < price(ring_plan).total_s \
            else ring_plan

    def _plan_searched_order(self, collective, shard_bytes, names, sizes,
                             health=None, *, include_latency=True):
        """Cross-world order search (``PlanPolicy.order`` = ``"electrical"``
        or ``"optical"``): enumerate candidate stage orders, price every
        candidate CollectivePlan under BOTH cost backends
        (``core.planner.search_stage_orders``), return the named backend's
        winner.  ``plan`` caches the result per context key, so the search
        runs once per (collective, payload, axes, policy, links) point —
        the same plan object the executor interprets is the one the
        optical pricer certified cheapest.  The search verdicts ride in
        ``meta["order_search"]`` for telemetry."""
        from ..core.planner import search_stage_orders
        from .staged_allgather import link_for_axis

        axes = [(n, sizes[n], link_for_axis(n, self.links)) for n in names]
        kw = {} if self.policy.optical is None else {"system": self.policy.optical}
        # the search derates links / shrinks wavelengths / prunes orders
        # crossing dead directions itself — pass the raw table plus health
        # (DeadDirectionError with zero survivors → fallback upstream)
        search = search_stage_orders(
            axes, shard_bytes, collective=collective,
            backend=self.policy.order, max_chunks=self.policy.max_chunks,
            health=health, include_latency=include_latency,
            reconfig=self.policy.reconfig, **kw,
        )
        best = search.best
        eb = search.best_by("electrical")
        ob = search.best_by("optical")
        plan = best.plan
        return dataclasses.replace(
            plan,
            meta={**plan.meta,
                  "axis_names": tuple(names),
                  "order_search": {
                      "backend": search.backend,
                      "order": best.order,
                      "regime": best.regime,
                      "electrical_s": best.electrical_s,
                      "optical_s": best.optical_s,
                      "optical_steps": best.optical_steps,
                      "electrical_best_order": eb.order,
                      "optical_best_order": ob.order,
                      # circuit/topology changes the winner's lowered
                      # schedule needs on a reconfigurable fabric
                      "reconfigurations": best.reconfigurations,
                      # genuine cross-world disagreement only: a strictly
                      # cheaper optical order, not an equal-cost tie-break
                      "flipped": search.flipped,
                      # the two worlds picked different plan FAMILIES
                      # (one latency, one bandwidth) — strictly cheaper
                      "regime_flipped": search.regime_flipped,
                      # orders a dead ring direction made illegal
                      "pruned": search.pruned,
                  }})

    def _plan_forced_order(self, collective, shard_bytes, names, sizes,
                           health=None):
        """Policy-forced stage order: build the schedule for exactly this
        AG order (RS runs the reverse; AR is RS-order + its reverse; a2a
        runs the given order directly — its digit transposes commute)."""
        from ..core.planner import choose_hop_schedule
        from .staged_allgather import link_for_axis

        ag_order = tuple(self.policy.order)
        if sorted(ag_order) != sorted(names):
            raise ValueError(
                f"policy order {ag_order} must permute the axes {names}")
        rs_order = tuple(reversed(ag_order))
        order = {"ag": ag_order, "rs": rs_order,
                 "ar": rs_order + tuple(reversed(rs_order)),
                 "a2a": ag_order}[collective]
        exec_order = order if collective != "ar" else rs_order
        factors = [sizes[n] for n in exec_order]
        links = [link_for_axis(n, self.links) for n in exec_order]
        sched = choose_hop_schedule(
            factors, links, shard_bytes,
            max_chunks=self.policy.max_chunks, collective=collective,
            health=health, axis_names=exec_order,
        )
        plan = sched.to_ir(order)
        return dataclasses.replace(
            plan, meta={**plan.meta, "axis_names": tuple(names)})

    # -- matmul fusion decision ---------------------------------------------
    def decide_fuse(
        self,
        names: Tuple[str, ...],
        rows: int,
        d_in: int,
        d_out: int,
        itemsize: int,
        *,
        n_matmuls: int = 1,
        fuse: object = None,
    ) -> bool:
        """Collective-matmul fuse decision under this context's policy:
        explicit True/False wins, ``"auto"`` asks the overlap model.
        ``rows`` is the per-block row count (one scattered shard's worth).
        """
        from .staged_allgather import link_for_axis

        fuse = self.policy.fuse if fuse is None else fuse
        if fuse != "auto":
            return bool(fuse)
        sizes = self._sizes(names)
        factors = [sizes[n] for n in names]
        lks = [link_for_axis(n, self.links) for n in names]
        t_blk = n_matmuls * matmul_block_time(rows, d_in, d_out)
        return plan_collective_matmul(
            factors, lks, rows * d_in * itemsize, t_blk).fuse


# --------------------------------------------------------------------------
# context stack
# --------------------------------------------------------------------------

_STATE = threading.local()

# fallback scope for axis_names-only call sites (no installed context):
# meshless, default links, so it plans but cannot run an op
_DEFAULT = CommContext()


def _stack() -> List[CommContext]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def current_context(default: object = _DEFAULT) -> Optional[CommContext]:
    """The innermost installed context (the meshless default scope when
    none is installed; pass ``default=None`` to get None instead)."""
    s = _stack()
    return s[-1] if s else default


@contextlib.contextmanager
def comm_context(
    mesh=None,
    axis_names: Optional[Sequence[str]] = None,
    *,
    links: Optional[Dict[str, LinkSpec]] = None,
    policy: Optional[PlanPolicy] = None,
    axis_sizes: Optional[Dict[str, int]] = None,
    health: Optional[LinkHealth] = None,
    **policy_overrides,
):
    """Install a :class:`CommContext` for the dynamic extent of the block.

    Nesting inherits: omitted mesh / axis_names / links / health come from
    the enclosing context, and ``policy_overrides`` (mode=, num_chunks=,
    max_chunks=, fuse=, order=, optical=, verify=, verify_retries=) merge
    into the enclosing policy — so

        with comm_context(mesh, ("pod", "tp")):
            with comm_context(mode="perhop"):       # same scope, forced mode
                ...

    Yields the context handle (usable as an explicit ``ctx=`` argument
    after the block exits, e.g. to keep its plan cache warm).
    """
    parent = current_context(None)
    if parent is not None:
        mesh = mesh if mesh is not None else parent.mesh
        axis_names = axis_names if axis_names is not None else parent.axis_names
        links = links if links is not None else parent.links
        axis_sizes = axis_sizes if axis_sizes is not None else parent.axis_sizes
        health = health if health is not None else parent.health
        base_policy = policy or parent.policy
    else:
        base_policy = policy or PlanPolicy()
    if policy_overrides:
        base_policy = base_policy.merged(**policy_overrides)
    ctx = CommContext(mesh, axis_names, links=links, policy=base_policy,
                      axis_sizes=axis_sizes, health=health)
    _stack().append(ctx)
    try:
        yield ctx
    finally:
        _stack().pop()


@contextlib.contextmanager
def use_context(ctx: CommContext):
    """Install the existing context ``ctx`` for the dynamic extent of the
    block (``comm_context`` makes a new one): code that resolves the
    innermost context, such as the MoE block's expert all-to-all, then
    shares ``ctx``'s plan cache."""
    _stack().append(ctx)
    try:
        yield ctx
    finally:
        _stack().pop()


def _resolve(ctx: Optional[CommContext], axes) -> Tuple[CommContext, Tuple[str, ...]]:
    c = ctx if ctx is not None else current_context()
    return c, c._names(axes)


def legacy_chunks(num_chunks: Optional[int]) -> Optional[int]:
    """Normalize the legacy entry points' ``num_chunks`` (default 1 meaning
    "no chunking") to the api's override convention (None = follow the
    plan) — one spelling for every shim."""
    return num_chunks if num_chunks is not None and num_chunks > 1 else None


# --------------------------------------------------------------------------
# plan resolution helpers
# --------------------------------------------------------------------------

def _fit_plan(plan: CollectivePlan, length: int, granularity: int) -> CollectivePlan:
    """Clamp the chunk count to what divides the payload; a fit that
    collapses to one chunk normalizes the mode back to ``oneshot``
    (``CollectivePlan.with_chunks``) so a plan never executes one-shot
    while labeled ``chunked``."""
    from .staged_collectives import fit_chunks  # lazy: cycle

    if plan.num_chunks > 1:
        plan = plan.with_chunks(fit_chunks(length, granularity, plan.num_chunks))
    return plan


def _apply_overrides(
    plan: CollectivePlan, mode: Optional[str], num_chunks: Optional[int]
) -> CollectivePlan:
    """Mode/chunk overrides on top of a planner-resolved plan — ONE
    implementation for the per-call and the policy path.

    * mode alone — ``with_mode`` (restores that mode's own chunk decision;
      a one-chunk wavefront normalizes to its pure mode);
    * chunks > 1 alone — resize the wavefront; a plan not already in a
      chunked-family mode is forced to ``chunked`` (``hybrid`` keeps its
      ring stages, the count just resizes its wavefront);
    * both explicit with a chunked-family mode — honored verbatim, so
      ``mode="hybrid", num_chunks=4`` runs a 4-chunk hybrid even when the
      planner's own hybrid scan collapsed to one chunk.
    """
    if mode in ("chunked", "hybrid") and num_chunks is not None \
            and num_chunks > 1:
        return dataclasses.replace(plan, mode=mode, num_chunks=num_chunks)
    if mode is not None:
        plan = plan.with_mode(mode)
    if num_chunks is not None:
        plan = plan.with_chunks(num_chunks)
        if num_chunks > 1 and plan.mode not in ("chunked", "hybrid"):
            plan = dataclasses.replace(plan, mode="chunked",
                                       num_chunks=num_chunks)
    return plan


def _local_plan(ctx, collective, names, x, axis, *, mode, num_chunks,
                scattered, regime=None):
    """Plan + runtime fit for one op call on this rank's array.
    ``scattered``: whether ``x`` is already the scattered shard (AG input)
    or the full-length local array (RS/AR input).  ``regime`` forces a plan
    family; None resolves it from the policy + these per-call overrides (a
    mode/chunk override plans in the bandwidth family)."""
    sizes = ctx._sizes(names)
    n_total = math.prod(sizes.values())
    nbytes = x.numel() * x.element_size()
    shard_bytes = nbytes if scattered else nbytes / n_total
    if regime is None:
        regime = ctx._effective_regime(mode, num_chunks)
    plan = ctx.plan(collective, shard_bytes, axes=names,
                    shape=tuple(x.shape), dtype=x.dtype, regime=regime)
    plan = _apply_overrides(plan, mode, num_chunks)
    granularity = 1 if scattered else n_total
    return _fit_plan(plan, x.shape[axis], granularity), n_total


def _require_mesh(ctx: CommContext, op: str):
    if ctx.mesh is None:
        raise ValueError(
            f"{op} needs a mesh and the active CommContext has none; "
            f"install one via comm_context(mesh, axis_names)")
    return ctx.mesh


def _global_path(ctx: CommContext, op, x, axis: int, names, sharded_in: bool,
                 sharded_out: bool, **kw):
    """The global-array path of ``op`` for the DTensor ``x`` (the
    reference's ``_run_wrapped``, taken outside an axis env): redistributed
    to its in_spec, ``op`` on the local array, wrapped at its out_spec."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if ctx.mesh is None:  # the reference's _require_mesh(ctx, "this op")
        raise ValueError(
            "this op was called outside shard_map and the active CommContext "
            "has no mesh; install one via comm_context(mesh, axis_names)")
    mesh = x.device_mesh
    dims = {mesh.mesh_dim_names.index(n) for n in names}

    def placements(sharded):
        return [Shard(axis) if sharded and i in dims else Replicate()
                for i in range(mesh.ndim)]

    y = x.redistribute(mesh, placements(sharded_in)).to_local()
    out = op(y, axis=axis, axes=names, ctx=ctx, **kw)
    stride = torch.empty(x.shape, device="meta").stride()
    return DTensor.from_local(out, mesh, placements(sharded_out), run_check=False,
                              shape=x.shape, stride=stride)


def _run_local(ctx, y, plan, axis):
    """Execute a plan on this rank's array over the context's mesh,
    verified when the policy says so.  A verified run's fallback flag is
    summed over the plan's group, so every rank counts the same executor
    fallback (the reference's ``psum`` of ``used_fallback``) and their
    ``CacheStats`` agree."""
    from .plan_executor import (  # lazy: cycle
        execute_plan,
        execute_plan_verified,
        plan_axis_names,
    )

    if not ctx.policy.verify:
        return execute_plan(y, plan, axis=axis, mesh=ctx.mesh)
    out, diag = execute_plan_verified(y, plan, axis=axis, mesh=ctx.mesh,
                                      retries=ctx.policy.verify_retries)
    fell = diag["used_fallback"].to(torch.int32).reshape(1)
    if int(ctx.mesh.psum(fell, plan_axis_names(plan))) > 0:
        ctx.cache_stats.fallbacks += 1
    return out


#: the collective whose result is the cotangent of each one's input (the
#: transpose of a sum-of-ranks loss): AG and RS swap, AR and a2a are their
#: own duals (a tiled all-to-all is an involution)
_DUAL = {"ag": "rs", "rs": "ag", "ar": "ar", "a2a": "a2a"}


class _Collective(torch.autograd.Function):
    """A collective under grad mode: ``run`` forward, the dual collective
    ``dual`` backward.  Both are closures over the context and mesh, so the
    backward needs no installed context (autograd may run it on a thread
    of its own)."""

    @staticmethod
    def forward(fctx, y, run, dual):
        fctx.dual = dual
        return run(y)

    @staticmethod
    def backward(fctx, g):
        return fctx.dual(g.contiguous()), None, None


def _differentiable(y, run, collective, ctx, names, axis):
    """``run(y)``, carrying the gradient to ``y`` through the dual
    collective when grad mode is on and ``y`` requires it."""
    if not (torch.is_grad_enabled() and y.requires_grad):
        return run(y)
    op = {"ag": all_gather, "rs": reduce_scatter, "ar": all_reduce,
          "a2a": all_to_all}[_DUAL[collective]]
    return _Collective.apply(y, run, lambda g: op(g, axis=axis, axes=names, ctx=ctx))


def _run_planned(ctx, y, plan, axis, names):
    return _differentiable(y, lambda v: _run_local(ctx, v, plan, axis),
                           plan.collective, ctx, names, axis)


# --------------------------------------------------------------------------
# module-level ops
# --------------------------------------------------------------------------

def all_gather(
    x: torch.Tensor,
    *,
    axis: int = 0,
    axes: Optional[Sequence[str]] = None,
    ctx: Optional[CommContext] = None,
    mode: Optional[str] = None,
    num_chunks: Optional[int] = None,
) -> torch.Tensor:
    """Context-planned staged all-gather over the context axes.

    ``x`` is this rank's shard; returns the full gather, bit-identical to
    ``lax.all_gather(x, axes, axis=axis, tiled=True)``.  A DTensor is the
    global array, sharded along ``axis`` for the call; it comes back
    replicated.
    ``mode``/``num_chunks`` override the context policy for this call."""
    ctx, names = _resolve(ctx, axes)
    if axis < 0:
        axis += x.dim()
    if is_dtensor(x):
        return _global_path(ctx, all_gather, x, axis, names, True, False,
                            mode=mode, num_chunks=num_chunks)
    _require_mesh(ctx, "all_gather")
    plan, _ = _local_plan(ctx, "ag", names, x, axis,
                          mode=mode, num_chunks=num_chunks, scattered=True)
    return _run_planned(ctx, x, plan, axis, names)


def reduce_scatter(
    x: torch.Tensor,
    *,
    axis: int = 0,
    axes: Optional[Sequence[str]] = None,
    ctx: Optional[CommContext] = None,
    mode: Optional[str] = None,
    num_chunks: Optional[int] = None,
) -> torch.Tensor:
    """Context-planned staged reduce-scatter (equals ``lax.psum_scatter``
    tiled, canonical blocks).  ``x`` is this rank's full-length addend;
    returns its block of the sum.  A DTensor is replicated for the call
    and comes back sharded along ``axis``."""
    ctx, names = _resolve(ctx, axes)
    if axis < 0:
        axis += x.dim()
    if is_dtensor(x):
        return _global_path(ctx, reduce_scatter, x, axis, names, False, True,
                            mode=mode, num_chunks=num_chunks)
    _require_mesh(ctx, "reduce_scatter")
    plan, _ = _local_plan(ctx, "rs", names, x, axis,
                          mode=mode, num_chunks=num_chunks, scattered=False)
    return _run_planned(ctx, x, plan, axis, names)


def all_reduce(
    x: torch.Tensor,
    *,
    axis: int = -1,
    axes: Optional[Sequence[str]] = None,
    ctx: Optional[CommContext] = None,
    mode: Optional[str] = None,
    num_chunks: Optional[int] = None,
) -> torch.Tensor:
    """Context-planned staged all-reduce (equals ``lax.psum``).

    ``axis`` only selects which dim the staged RS+AG pipeline scatters
    along.  A length not divisible by the rank product takes one flat
    all-reduce over the axes' process group, so model code never has to
    care about divisibility (the old ``tp_all_reduce`` contract).  A
    DTensor is replicated for the call and comes back replicated."""
    ctx, names = _resolve(ctx, axes)
    if axis < 0:
        axis += x.dim()
    if is_dtensor(x):
        return _global_path(ctx, all_reduce, x, axis, names, False, False,
                            mode=mode, num_chunks=num_chunks)
    mesh = _require_mesh(ctx, "all_reduce")
    n_total = math.prod(ctx._sizes(names).values())
    if x.shape[axis] % n_total:  # before planning: don't cache a plan never run
        return _differentiable(x, lambda v: mesh.psum(v, names), "ar", ctx, names, axis)
    plan, _ = _local_plan(ctx, "ar", names, x, axis,
                          mode=mode, num_chunks=num_chunks, scattered=False)
    return _run_planned(ctx, x, plan, axis, names)


def all_to_all(
    x: torch.Tensor,
    *,
    axis: int = 0,
    axes: Optional[Sequence[str]] = None,
    ctx: Optional[CommContext] = None,
    mode: Optional[str] = None,
    num_chunks: Optional[int] = None,
) -> torch.Tensor:
    """Context-planned staged all-to-all over the context axes (the
    expert-parallel MoE dispatch/combine primitive).

    ``x`` is this rank's full exchange buffer: dim ``axis`` holds N equal
    destination blocks in canonical (major-first) order; the result holds
    the N received blocks by origin, bit-identical to ``lax.all_to_all(x,
    axes, split_axis=axis, concat_axis=axis, tiled=True)``.  A DTensor is
    sharded along ``axis`` for the call and comes back sharded the same way.
    ``mode``/``num_chunks`` override the context policy for this call."""
    ctx, names = _resolve(ctx, axes)
    if axis < 0:
        axis += x.dim()
    if is_dtensor(x):
        return _global_path(ctx, all_to_all, x, axis, names, True, True,
                            mode=mode, num_chunks=num_chunks)
    _require_mesh(ctx, "all_to_all")
    n_total = math.prod(ctx._sizes(names).values())
    plan = ctx.plan("a2a", x.numel() * x.element_size(), axes=names,
                    shape=tuple(x.shape), dtype=x.dtype)
    plan = _apply_overrides(plan, mode, num_chunks)
    plan = _fit_plan(plan, x.shape[axis], n_total)
    return _run_planned(ctx, x, plan, axis, names)


# --------------------------------------------------------------------------
# fused collective-matmul ops
# --------------------------------------------------------------------------

def allgather_matmul(
    x: torch.Tensor,
    w,
    *,
    axis: int = 0,
    axes: Optional[Sequence[str]] = None,
    ctx: Optional[CommContext] = None,
    fuse: object = None,
):
    """``all_gather(x) @ w`` with the gather planned by the context and,
    when the policy or the overlap model says so, run as fused rings that
    multiply each block the hop it lands
    (``comms.collective_matmul.fused_allgather_matmul``).

    ``x`` is this rank's (scattered) block and ``w`` the local column
    slice; ``w`` may be one weight or a sequence sharing the gather (SwiGLU
    gate+up).  Returns ``(gathered_x, out)`` with ``out`` matching ``w``'s
    structure.  ``fuse``: None (the context policy) / True / False /
    ``"auto"``."""
    ctx, names = _resolve(ctx, axes)
    mesh = _require_mesh(ctx, "allgather_matmul")
    single = not isinstance(w, (list, tuple))
    ws = (w,) if single else tuple(w)
    if axis < 0:
        axis += x.dim()
    plan, _ = _local_plan(ctx, "ag", names, x, axis,
                          mode=None, num_chunks=None, scattered=True)
    rows = x.numel() // x.shape[-1]
    d_in, d_out = ws[0].shape[-2], ws[0].shape[-1]
    do_fuse = ctx.decide_fuse(names, rows, d_in, d_out, x.element_size(),
                              n_matmuls=len(ws), fuse=fuse)
    if do_fuse:
        # fused rings everywhere: the fusion decision already says the
        # per-hop decomposition wins, so the plain collective's stage modes
        # (a tradeoff with no compute to hide) don't apply.  A latency
        # (exchange) plan has no ring order to fuse against: re-plan in the
        # bandwidth family for the stage order.
        if any(s.mode == "exchange" for s in plan.stages):
            plan, _ = _local_plan(ctx, "ag", names, x, axis, mode=None,
                                  num_chunks=None, scattered=True,
                                  regime="bandwidth")
        g, outs = fused_allgather_matmul(x, ws, names, plan.axes, axis, mesh)
    else:
        g = _run_planned(ctx, x, plan, axis, names)
        outs = tuple(_mm(g, wi) for wi in ws)
    return g, (outs[0] if single else outs)


def matmul_reduce_scatter(
    h: torch.Tensor,
    w: torch.Tensor,
    *,
    axis: int = 0,
    axes: Optional[Sequence[str]] = None,
    ctx: Optional[CommContext] = None,
    fuse: object = None,
) -> torch.Tensor:
    """``psum_scatter(h @ w)`` with the combine planned by the context and,
    when fusion wins, the block matmuls feeding the ring just-in-time
    (``comms.collective_matmul.fused_matmul_reduce_scatter``).

    ``h`` is this rank's full-length activation and ``w`` the local row
    slice; the output is this rank's block of the sum along ``axis``."""
    ctx, names = _resolve(ctx, axes)
    mesh = _require_mesh(ctx, "matmul_reduce_scatter")
    if axis < 0:
        axis += h.dim()
    n_total = math.prod(ctx._sizes(names).values())
    out_bytes = (h.numel() // h.shape[-1]) * w.shape[-1] * h.element_size()
    shape = tuple(h.shape) + tuple(w.shape)
    plan = ctx.plan("rs", out_bytes / n_total, axes=names, shape=shape, dtype=h.dtype)
    # the RS runs on the matmul OUTPUT: when the scatter axis is the
    # feature axis, its length is w's d_out, not h's contracted d_in
    out_len = w.shape[-1] if axis == h.dim() - 1 else h.shape[axis]
    plan = _fit_plan(plan, out_len, n_total)
    rows = h.numel() // h.shape[-1]
    do_fuse = ctx.decide_fuse(names, max(1, rows // n_total), w.shape[0], w.shape[1],
                              h.element_size(), fuse=fuse)
    if do_fuse:
        if any(s.mode == "exchange" for s in plan.stages):
            # fused rings need a ring stage order, not an exchange chain
            plan = ctx.plan("rs", out_bytes / n_total, axes=names, shape=shape,
                            dtype=h.dtype, regime="bandwidth")
        return fused_matmul_reduce_scatter(h, w, names, plan.axes, axis, mesh)
    return _run_planned(ctx, _mm(h, w), plan, axis, names)
