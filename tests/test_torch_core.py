"""The port's copy of the paper's planner and optics simulator against the original.

``repro_torch.core``, ``repro_torch.optics`` and
``repro_torch.configs.optree_paper`` are copies of ``repro.core``,
``repro.optics`` and ``repro.configs.optree_paper``: numpy and the
standard library only, so the port imports nothing of the reference.  The
code is the same, so every exported name must give the same result on the
same inputs, compared *equal*: dataclass fields, floats, step counts,
schedules, plans and simulated times, and the same exception where one is
raised.  The inputs are the deterministic grid of
``tests/test_plan_conformance.py`` (factorizations x shard sizes x
collectives x link tables), its health grid, Table I, the Fig. 4-6 sweeps
of ``optree_paper`` and fault traces from seeds.  None of the reference's
own invariants is asserted here, only parity.
"""
import dataclasses
import enum
import itertools
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.configs.optree_paper as jpaper
import repro.core as jcore
import repro.optics as joptics
import repro_torch.configs.optree_paper as tpaper
import repro_torch.core as tcore
import repro_torch.optics as toptics

REF = SimpleNamespace(core=jcore, optics=joptics, paper=jpaper, name="repro")
PORT = SimpleNamespace(core=tcore, optics=toptics, paper=tpaper, name="repro_torch")

# the grid of tests/test_plan_conformance.py:82-88, and its link tables
GRID_FACTORS = [(2,), (8,), (2, 4), (16, 2), (2, 3, 4), (1, 4, 2)]
GRID_SHARDS = [64.0, 64 * 2**10, 1 * 2**20, 8 * 2**20]
GRID_COLLS = ["ag", "rs", "ar", "a2a"]
LINK_VARIANTS = ["dcn_ici", "slow_last", "fat"]
# tests/test_plan_conformance.py:342, index-keyed derates and lost wavelengths
HEALTH_GRID = [
    pytest.param({}, {}, id="healthy"),
    pytest.param({(0, 0): 0.5, (0, 1): 0.5}, {}, id="derate-both"),
    pytest.param({(0, 0): 0.25}, {}, id="derate-cw-only"),
    pytest.param({}, {0: (0, 1)}, id="lost-two-wl"),
    pytest.param({(0, 0): 0.5, (1, 1): 0.75}, {1: (1, 3)}, id="mixed"),
]


def same(a, b, path="result"):
    """Structural equality across the two packages: dataclasses by class
    name and field, floats exactly (nan equal to nan), containers item by
    item."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        return
    if isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name, path
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, (set, frozenset)):
        assert type(a) is type(b) and a == b, path
        return
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
        return
    if isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
        return
    assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


def outcome(fn, *args, **kwargs):
    """("ok", value) or ("raised", exception class name, message)."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return ("raised", type(e).__name__, str(e))


def both(run):
    same(run(REF), run(PORT))


def test_exported_names_are_the_originals():
    for mod in ("core", "optics"):
        names = {n for n in vars(getattr(REF, mod)) if not n.startswith("_")}
        assert names == {n for n in vars(getattr(PORT, mod)) if not n.startswith("_")}
    assert {n for n in vars(jpaper) if n.isupper()} == {n for n in vars(tpaper) if n.isupper()}


def _links(pkg, factors, variant):
    c = pkg.core
    slow = c.LinkSpec("slow", 1e9, 1e-5)
    fast = c.LinkSpec("fast", 50e9, 1e-6)
    fat = c.LinkSpec("fat", 1e6, 1e-12)
    if variant == "dcn_ici":
        return [c.DCN_LINK] + [c.ICI_LINK] * (len(factors) - 1)
    if variant == "slow_last":
        return [fast] * (len(factors) - 1) + [slow]
    return [fat] * len(factors)


@pytest.mark.parametrize("factors,shard,coll,variant", [
    pytest.param(f, s, c, v, id=f"{'x'.join(map(str, f))}-{int(s)}B-{c}-{v}")
    for f, s, c, v in itertools.product(GRID_FACTORS, GRID_SHARDS, GRID_COLLS, LINK_VARIANTS)])
def test_planner_grid_matches(factors, shard, coll, variant):
    """The hop-schedule planner, its IR, the electrical price of every
    mode and chunk count, the per-hop expansion, the order search, and
    the optical price and simulator of every searched candidate."""

    def run(pkg):
        c = pkg.core
        links = _links(pkg, factors, variant)
        hs = c.choose_hop_schedule(factors, links, shard, collective=coll)
        ir = hs.to_ir()
        out = {"hs": hs, "ir": ir, "kind": c.collective_kind(coll),
               "optical_bytes": c.optical_message_bytes(ir)}
        for mode in ("oneshot", "chunked", "perhop", "hybrid"):
            out[mode] = c.price(ir.with_mode(mode), detailed=True)
            for chunks in (1, 2, 8):
                out[f"{mode}/{chunks}"] = c.price(ir.with_mode(mode).with_chunks(chunks))
        out["expanded"] = outcome(c.expand_hops, ir.with_mode("perhop"))
        axes = [(f"x{i}", f, lk) for i, (f, lk) in enumerate(zip(factors, links))]
        if shard in (64.0, 1 * 2**20):  # the search costs seconds on the 24- and 32-node grids
            out["search_e"] = c.search_stage_orders(axes, shard, collective=coll)
        n = math.prod(factors)
        # the optical price ignores the link table; the simulator enumerates
        # every transmission, so small worlds only
        if n <= 16 and variant == "dcn_ici":
            sys_w = dataclasses.replace(c.TERARACK, n_nodes=max(n, 2), wavelengths=4)
            srch = c.search_stage_orders(axes, shard, collective=coll, backend="optical",
                                         system=sys_w)
            out["search_o"] = srch
            for i, cand in enumerate(srch.candidates):
                sched = c.schedule_from_ir(cand.plan, 4)
                out[f"sim{i}"] = pkg.optics.simulate(
                    sched, sys_w, c.optical_message_bytes(cand.plan), check=True)
                out[f"price{i}"] = c.price(cand.plan, sys_w)
        if len(factors) == 1:
            out["staged"] = c.plan_staged_allgather(factors[0], shard, links[0])
        out["axis_order"] = c.plan_axis_order(list(zip(factors, links)), shard)
        return out

    both(run)


def _health(pkg, names, derates, lost):
    return pkg.core.LinkHealth.make(
        derate={(names[i % len(names)], d): f for (i, d), f in derates.items()},
        lost_wavelengths={names[i % len(names)]: tuple(sorted(wl))
                          for i, wl in lost.items() if wl})


@pytest.mark.parametrize("coll", ["ag", "rs", "ar", "a2a"])
@pytest.mark.parametrize("derates,lost", HEALTH_GRID)
def test_health_grid_matches(derates, lost, coll, tmp_path):
    """The health model and everything priced, lowered, validated and
    simulated under it, on a (2, 4) mesh with 4 wavelengths."""

    def run(pkg):
        c = pkg.core
        names = ["x0", "x1"]
        health = _health(pkg, names, derates, lost)
        fast = c.LinkSpec("fast", 50e9, 1e-6)
        axes = [(nm, s, fast) for nm, s in zip(names, (2, 4))]
        sys_w = dataclasses.replace(c.TERARACK, n_nodes=8, wavelengths=4)
        out = {"health": health, "fp": health.fingerprint(), "describe": health.describe(),
               "json": health.to_json(), "hfp": c.health_fingerprint(health),
               "none_fp": c.health_fingerprint(None), "healthy": health.is_healthy,
               "factors": [health.axis_factor(n) for n in names],
               "dirs": [health.direction_factor(n, d) for n in names for d in (0, 1)],
               "lost": health.lost_for(names), "dead": health.dead_directions(names),
               "links": health.degrade_links({n: fast for n in names})}
        path = tmp_path / f"{pkg.name}_health.json"
        path.write_text(json.dumps(health.to_json()))
        out["loaded"] = c.load_health(path, expect_axes=names)
        out["from_json"] = c.LinkHealth.from_json(health.to_json())
        srch = c.search_stage_orders(axes, 64 * 2**10, collective=coll, backend="optical",
                                     system=sys_w, health=health)
        out["search"] = srch
        for i, cand in enumerate(srch.candidates):
            out[f"e{i}"] = outcome(c.price, cand.plan, health=health)
            out[f"o{i}"] = outcome(c.price, cand.plan, sys_w, health=health)
            sched = outcome(c.schedule_from_ir, cand.plan, 4, health=health)
            out[f"sched{i}"] = sched
            if sched[0] == "ok":
                out[f"valid{i}"] = outcome(c.validate_schedule, sched[1], health=health)
                out[f"vh{i}"] = outcome(c.validate_health, sched[1], health)
                out[f"sim{i}"] = outcome(pkg.optics.simulate, sched[1], sys_w,
                                         c.optical_message_bytes(cand.plan), check=True,
                                         health=health)
        out["hop"] = outcome(c.choose_hop_schedule, [2, 4], [fast, fast], 64 * 2**10,
                             collective=coll, health=health, axis_names=names)
        return out

    both(run)


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_fault_trace_matches(seed):
    def run(pkg):
        c = pkg.core
        trace = c.FaultTrace.generate(["data", "model"], 40, seed=seed)
        health = c.LinkHealth.healthy()
        applied = []
        for step in range(40):
            health = trace.apply_step(health, step)
            applied.append((health.fingerprint(), [e.describe() for e in trace.at(step)]))
        return {"trace": trace, "replay": [trace.replay(s) for s in (0, 10, 39)],
                "applied": applied,
                "event": c.FaultEvent(step=3, kind="derate", axis="data", direction=0,
                                      derate=0.5),
                "errors": [outcome(c.LinkHealth.make, dead=[("a", 0), ("a", 1)]),
                           outcome(c.LinkHealth.make(dead=[("a", 0), ("a", 1)]).axis_factor,
                                   "a"),
                           outcome(c.LinkHealth.make, derate={("a", 0): 1.5}),
                           outcome(c.LinkHealth.make, derate={("a", 2): 0.5})]}

    both(run)
    # the exception classes keep the reference's hierarchy
    for pkg in (REF, PORT):
        assert issubclass(pkg.core.DeadAxisError, pkg.core.HealthError)
        assert issubclass(pkg.core.DeadDirectionError, pkg.core.HealthError)
        assert issubclass(pkg.core.HealthError, ValueError)


def test_table1_matches():
    both(lambda pkg: {"t": pkg.core.table1(1024, 64),
                      "paper": pkg.core.table1(pkg.paper.TABLE1_N, pkg.paper.TABLE1_W)})


@pytest.mark.parametrize("n", [16, 64, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("w", [1, 8, 64, 96, 128])
def test_step_counts_match(n, w):
    def run(pkg):
        c = pkg.core
        out = {"ring": c.ring_steps(n, w), "ne": c.neighbor_exchange_steps(n, w),
               "one": c.one_stage_steps(n, w), "wrht": c.wrht_steps_formula(n, w),
               "wrht_paper": c.wrht_steps_paper_table(n, w),
               "opt": c.optree_optimal_steps(n, w), "argmin": c.optimal_depth_argmin(n, w),
               "thm2": [c.optimal_depth_thm2(n, rounding=r) for r in ("round", "ceil")],
               "line": c.lemma1_wavelengths_line(n), "ring_w": c.lemma1_wavelengths_ring(n)}
        for k in range(1, 11):
            factors = c.balanced_factors(n, k)
            plan = c.OpTreePlan(n, factors)
            out[k] = (factors, plan, outcome(c.optree_steps_exact, plan, w),
                      outcome(c.optree_steps_thm1, n, k, w))
        return out

    both(run)


@pytest.mark.parametrize("n,w", [(16, 2), (16, 8), (64, 4), (64, 64)])
def test_schedules_and_simulator_match(n, w):
    def run(pkg):
        c, sys_w = pkg.core, dataclasses.replace(pkg.core.TERARACK, n_nodes=n, wavelengths=w)
        scheds = {"ring": c.build_ring_schedule(n, w), "ne": c.build_ne_schedule(n, w),
                  "one": c.build_one_stage_schedule(n, w)}
        for k in (1, 2, 3):
            scheds[f"optree{k}"] = c.build_optree_schedule(
                c.OpTreePlan(n, c.balanced_factors(n, k)), w)
        out = {}
        for name, sched in scheds.items():
            out[name] = (sched, outcome(c.validate_schedule, sched),
                         pkg.optics.simulate(sched, sys_w, 4 * 2**20, detailed=True))
        return out

    both(run)


@pytest.mark.parametrize("fig", ["fig4", "fig5", "fig6"])
def test_paper_sweeps_match(fig):
    """The Fig. 4-6 sweeps of ``optree_paper`` through ``eq3_time`` and
    ``compare_algorithms``, for each collective."""

    def run(pkg):
        c, o, p = pkg.core, pkg.optics, pkg.paper
        out = {"system": p.SYSTEM}
        if fig == "fig4":
            for n in p.FIG4_NODES:
                out[n] = {"optimal_depth": c.optimal_depth_argmin(n, p.SYSTEM.wavelengths)}
                for k in p.FIG4_DEPTHS:
                    plan = c.OpTreePlan(n, c.balanced_factors(n, k))
                    steps = c.optree_steps_exact(plan, p.SYSTEM.wavelengths)
                    out[n][k] = (steps, c.eq3_time(p.SYSTEM, p.FIG4_MESSAGE_BYTES, steps),
                                 c.eq3_time(p.SYSTEM, p.FIG4_MESSAGE_BYTES, steps,
                                            detailed=True),
                                 c.allgather_time(p.SYSTEM, p.FIG4_MESSAGE_BYTES, steps))
            return out
        cells = ([(n, p.SYSTEM.wavelengths) for n in p.FIG5_NODES] if fig == "fig5"
                 else [(p.TABLE1_N, w) for w in p.FIG6_WAVELENGTHS])
        msgs = p.FIG5_MESSAGES if fig == "fig5" else p.FIG6_MESSAGES
        for n, w in cells:
            sys_w = dataclasses.replace(p.SYSTEM, n_nodes=n, wavelengths=w)
            for m in msgs:
                for coll in ("all-gather", "reduce-scatter", "all-reduce"):
                    out[(n, w, m, coll)] = o.compare_algorithms(
                        n, w, m, sys_w, ("optree", "wrht", "wrht-paper", "ring", "ne",
                                         "one-stage"), collective=coll)
                out[(n, w, m)] = (c.step_time(sys_w, m / 64), c.step_time(sys_w, m, detailed=True))
        return out

    both(run)


def test_cost_model_and_links_match(tmp_path):
    """The optical system's helpers, reconfiguration pricing, transfer
    times, the calibration readers, and the IR's building blocks."""

    def run(pkg):
        c = pkg.core
        links = {"data": c.LinkSpec("data", 2e10, 2e-6), "model": c.ICI_LINK}
        path = tmp_path / f"{pkg.name}_links.json"
        path.write_text(json.dumps({"fitted_links": {
            k: {"bandwidth_bytes": v.bandwidth_bytes, "alpha_s": v.alpha_s}
            for k, v in links.items()}}))
        sys_r = dataclasses.replace(c.TERARACK, n_nodes=16, wavelengths=4,
                                    circuit_reconfig_s=2e-6, reconfig_overlap=True)
        srch = c.search_stage_orders([(None, 16, c.ICI_LINK)], 1 * 2**20, backend="optical",
                                     system=sys_r)
        plan = srch.best.plan
        stage = plan.stages[0]
        return {
            "collectives": c.COLLECTIVES, "kinds": [c.collective_kind(k) for k in c.COLLECTIVES],
            "bad_kind": outcome(c.collective_kind, "nope"),
            "terarack": c.TERARACK, "dcn": c.DCN_LINK, "ici": c.ICI_LINK,
            "derived_w": [c.derive_wavelengths(links), c.derive_wavelengths(links, sys_r)],
            "transfer": [c.transfer_time(c.ICI_LINK, b) for b in (0, 64, 2**20)]
                        + [c.transfer_time(sys_r, b) for b in (64, 2**20)],
            "loaded": c.load_links(path), "missing": outcome(c.load_links, tmp_path / "none.json"),
            "search": srch, "price": c.price(plan, sys_r, detailed=True),
            "reconfig": c.CircuitReconfig(events=2, exposed_s=1e-6),
            "stage": stage, "hop": c.Hop(transfers=(c.Transfer(0, 1, 0, 64.0),)),
            "plan_stage": c.PlanStage(factor=2, mode="oneshot", payload_bytes=64.0),
            "plan": c.CollectivePlan("ag", 2, 64.0, (c.PlanStage(2, "oneshot", 64.0),)),
            "expanded": outcome(c.expand_hops, plan.with_mode("perhop")),
            "sched": c.schedule_from_ir(plan, 4),
            "tx": c.Tx(0, 0, 0, 0, 1, 0, (0,)), "empty": c.Schedule(4, 2),
            "report": c.PriceReport("optical", "oneshot", 1.0, (1.0,)),
            "ag_plan": c.AllGatherPlan((), 0.0),
            "cand_types": [type(x).__name__ for x in (srch, srch.best)],
            "replans": [c.plan_staged_allgather(w, 4 * 2**20, c.ICI_LINK) for w in (64, 256)],
        }

    both(run)
    for pkg in (REF, PORT):  # names exported for isinstance checks and signatures
        assert pkg.core.OrderSearch.__name__ == "OrderSearch"
        assert pkg.core.OrderCandidate.__name__ == "OrderCandidate"
        assert pkg.core.HopSchedule.__name__ == "HopSchedule"
        assert pkg.optics.SimReport.__name__ == "SimReport"
