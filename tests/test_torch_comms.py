"""The port's comms planning against the reference's, in one process.

``repro_torch.comms`` copies the planning half of ``repro.comms``
(``plan_collectives``, ``CommContext.plan`` with its policy, cache and
health handling, ``_apply_overrides``, ``_fit_plan``): numpy on the A5a
planner copy, no process group needed.  Every plan must equal the
reference's field by field (stages, links, modes, chunks, ``meta``) and
every refusal must raise the same exception, over factors [8], [2, 4],
[4, 2] and [2, 2, 2], ag/rs/ar/a2a, shards from 64 B to 16 MiB, every
mode override, both regimes and the stage-order search on an asymmetric
links table.  Also here: the ``verify`` policy, accepted and validated
as the reference's, ``init_world``'s refusal to run a CUDA
world without enough cards, and every op in every mode in a world of one
gloo rank (the card's world: size-1 axes, no hops).
"""
import dataclasses
import enum
import math

import numpy as np
import pytest
import torch

import repro.comms.api as japi
import repro.comms.staged_collectives as jstaged
import repro.core as jcore
import repro_torch.comms.api as tapi
import repro_torch.comms.staged_collectives as tstaged
import repro_torch.core as tcore

FACTORS = {"8": ((8,), ("x",)), "2x4": ((2, 4), ("a", "b")),
           "4x2": ((4, 2), ("a", "b")), "2x2x2": ((2, 2, 2), ("a", "b", "c"))}
COLLS = ("ag", "rs", "ar", "a2a")
SHARDS = (64.0, 1024.0, 64 * 2.0**10, 2.0**20, 16 * 2.0**20)
#: policy variants: mode overrides, a chunk override, both regimes, the
#: electrical and optical order search and a forced reversed order
POLICIES = ("default", "mode_oneshot", "mode_chunked", "mode_perhop", "mode_hybrid",
            "chunks_4", "regime_bandwidth", "regime_latency", "order_electrical",
            "order_optical", "order_reversed")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same(a, b, path="result"):
    """Structural equality across the two packages: dataclasses by class
    name and field, floats exactly, containers item by item."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        return
    if isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name, path
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{path}: {list(a)} != {list(b)}"
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
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


def _asym(core):
    """tests/subproc/check_plan_executor.py's asymmetric table."""
    return {"a": core.LinkSpec("fast", 50e9, 1e-6), "b": core.LinkSpec("slow", 1e9, 1e-5)}


def _policy(api, core, variant, names):
    kw = {}
    if variant.startswith("mode_"):
        kw["mode"] = variant[5:]
    elif variant == "chunks_4":
        kw["num_chunks"] = 4
    elif variant.startswith("regime_"):
        kw["regime"] = variant[7:]
    elif variant in ("order_electrical", "order_optical"):
        kw["order"] = variant[6:]
        kw["optical"] = dataclasses.replace(core.TERARACK, n_nodes=8, wavelengths=2)
    elif variant == "order_reversed":
        kw["order"] = tuple(reversed(names))
    return api.PlanPolicy(**kw)


def _ctx(api, core, key, variant="default", links="asym"):
    factors, names = FACTORS[key]
    return api.CommContext(
        axis_names=names, axis_sizes=dict(zip(names, factors)),
        links=_asym(core) if links == "asym" else None,
        policy=_policy(api, core, variant, names))


@pytest.mark.parametrize("coll", COLLS)
@pytest.mark.parametrize("key", FACTORS)
def test_plan_collectives_matches_reference(key, coll):
    factors, names = FACTORS[key]
    sizes = dict(zip(names, factors))
    for links in (None, "asym"):
        for shard in SHARDS:
            got = [outcome(lambda: pkg.plan_collectives(
                sizes, names, shard, links=_asym(core) if links else None)[coll])
                for pkg, core in ((jstaged, jcore), (tstaged, tcore))]
            same(got[0], got[1], f"{key} {coll} {shard} B links {links}")


@pytest.mark.parametrize("variant", POLICIES)
@pytest.mark.parametrize("coll", COLLS)
@pytest.mark.parametrize("key", FACTORS)
def test_context_plan_matches_reference(key, coll, variant):
    """``CommContext.plan`` (meshless, ``axis_sizes``) under each policy,
    on the asymmetric table, for every shard size, and the cache counters
    after the sweep."""
    ctxs = [_ctx(api, core, key, variant) for api, core in ((japi, jcore), (tapi, tcore))]
    for shard in SHARDS:
        got = [outcome(ctx.plan, coll, shard) for ctx in ctxs]
        same(got[0], got[1], f"{key} {coll} {variant} {shard} B")
    same(ctxs[0].cache_stats, ctxs[1].cache_stats)


def _base_plans(core, api):
    ctx = api.CommContext(axis_names=("a", "b"), axis_sizes={"a": 2, "b": 4},
                          links=_asym(core))
    return [ctx.plan(coll, shard, regime="bandwidth")
            for coll in COLLS for shard in (1024.0, 2.0**20)]


@pytest.mark.parametrize("mode", (None, "oneshot", "chunked", "perhop", "hybrid"))
def test_apply_overrides_matches_reference(mode):
    pairs = zip(_base_plans(jcore, japi), _base_plans(tcore, tapi))
    for i, (jp, tp) in enumerate(pairs):
        for chunks in (None, 1, 2, 4, 8):
            same(outcome(japi._apply_overrides, jp, mode, chunks),
                 outcome(tapi._apply_overrides, tp, mode, chunks),
                 f"plan {i} mode {mode} chunks {chunks}")


def test_fit_plan_matches_reference():
    """Lengths that divide, divide only part of the chunk count, and not at
    all; granularity 1 (AG shards) and N (RS/AR/a2a blocks)."""
    pairs = list(zip(_base_plans(jcore, japi), _base_plans(tcore, tapi)))
    for jp, tp in pairs:
        for chunks in (1, 2, 4, 8):
            jc = japi._apply_overrides(jp, "chunked", chunks)
            tc = tapi._apply_overrides(tp, "chunked", chunks)
            for length in (1, 3, 8, 12, 16, 24, 64, 96, 1000):
                for gran in (1, 8):
                    same(outcome(japi._fit_plan, jc, length, gran),
                         outcome(tapi._fit_plan, tc, length, gran),
                         f"chunks {chunks} length {length} granularity {gran}")
    for n in (0, 1, 5, 7, 16, 33, 64, 4096):
        for gran in (1, 2, 8):
            for chunks in (1, 2, 4, 8, 16):
                assert tstaged.fit_chunks(n, gran, chunks) == jstaged.fit_chunks(n, gran, chunks)


def _telemetry_sequence(api, core):
    """Plans, a links update, faults and a recovery, in one context."""
    ctx = api.CommContext(axis_names=("a", "b"), axis_sizes={"a": 2, "b": 4})
    log = []
    for coll in COLLS:
        for shard in (256.0, 2.0**16, 2.0**22):
            ctx.plan(coll, shard)
    ctx.plan("ar", 256.0)  # a hit
    log.append(outcome(ctx.telemetry_snapshot))
    ctx.update_links(_asym(core))
    ctx.update_links(dict(ctx.links))  # the same table: no invalidation
    for coll in ("ag", "ar"):
        ctx.plan(coll, 2.0**16)
    log.append(outcome(ctx.telemetry_snapshot))
    ctx.report_fault(axis="b", derate=0.5)
    log.append(outcome(ctx.telemetry_snapshot))
    ctx.report_fault(axis="a", kind="dead", direction=0)
    ctx.report_fault(axis="a", kind="dead", direction=1)  # a dead axis: fallback plans
    log.append(outcome(ctx.plan, "rs", 2.0**16))
    log.append(outcome(ctx.telemetry_snapshot))
    ctx.report_fault(axis="a", kind="recover")
    log.append(outcome(ctx.telemetry_snapshot))
    log.append(outcome(ctx.latency_crossover, "rs"))
    log.append(ctx.plans())
    log.append([n for _, n in ctx.plan_usage()])
    log.append(ctx.decide_fuse(("a", "b"), 128, 256, 512, 2))
    return log, ctx.cache_stats.to_json()


def test_cache_stats_and_telemetry_match_reference():
    same(_telemetry_sequence(japi, jcore), _telemetry_sequence(tapi, tcore))
    _, stats = _telemetry_sequence(tapi, tcore)
    assert stats["hits"] and stats["invalidated"] and stats["replans_on_fault"]
    assert stats["fallbacks"] and stats["latency_plans"] and stats["ring_plans"]


def test_comm_context_nests_and_overrides_like_the_reference():
    def run(api):
        out = []
        with api.comm_context(axis_names=("a", "b"), axis_sizes={"a": 2, "b": 4}) as outer:
            out.append(api.current_context(None) is outer)
            with api.comm_context(mode="perhop", max_chunks=4) as inner:
                out.append((inner.axis_names, inner.axis_sizes, inner.policy))
                out.append(inner.plan("ag", 2.0**16))
            out.append(api.current_context(None) is outer)
        out.append(api.current_context(None))
        out.append(outcome(api.PlanPolicy, mode="bogus"))
        out.append(outcome(api.PlanPolicy, regime="latency", mode="chunked"))
        out.append(outcome(api.PlanPolicy, reconfig="hold"))
        out.append([api.legacy_chunks(c) for c in (None, 1, 4)])
        out.append(api.links_fingerprint(None))
        return out

    j, t = run(japi), run(tapi)
    assert j[0] and j[3] and j[4] is None
    same(j, t)


def test_plan_policy_verify_is_refused_naming_A10():
    """The fault layer (ROADMAP A10) is ported: ``verify=True`` is
    accepted as the reference's is, and what the reference refuses
    (a negative or non-int ``verify_retries``) the port refuses alike."""
    for api in (japi, tapi):
        pol = api.PlanPolicy(verify=True, verify_retries=2)
        assert pol.verify and pol.verify_retries == 2
        with api.comm_context(axis_names=("a",), axis_sizes={"a": 2}, verify=True) as ctx:
            assert ctx.policy.verify
    for bad in (-1, 1.5, "1"):
        j = outcome(japi.PlanPolicy, verify=True, verify_retries=bad)
        t = outcome(tapi.PlanPolicy, verify=True, verify_retries=bad)
        assert j[:2] == ("raised", "ValueError") and j == t, (bad, j, t)


def test_ops_need_a_mesh():
    x = torch.zeros(8)
    ctx = tapi.CommContext(axis_names=("a",), axis_sizes={"a": 2})
    for op in (tapi.all_gather, tapi.reduce_scatter, tapi.all_reduce, tapi.all_to_all):
        with pytest.raises(ValueError, match="comm_context"):
            op(x, ctx=ctx)


# --------------------------------------------------------------------------
# init_world and the world of one rank
# --------------------------------------------------------------------------

@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour; this host has a CUDA device")


def test_init_world_default_device_needs_a_card(no_card, tmp_path):
    from repro_torch.comms import init_world

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_world(store_path=str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_world("cuda", world_size=8, rank=0, store_path=str(tmp_path / "store"))
    assert not torch.distributed.is_initialized()


def test_init_world_refuses_more_ranks_than_cards(monkeypatch, tmp_path):
    """A CUDA world holds one rank per card: 2 ranks on 1 card raise before
    any process group is made."""
    from repro_torch.comms import init_world

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"2 ranks needs 2 cards.*device='cpu'"):
        init_world("cuda", world_size=2, rank=0, store_path=str(tmp_path / "store"))
    assert not torch.distributed.is_initialized()


@pytest.fixture
def world_of_one(tmp_path):
    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=1, rank=0, store_path=str(tmp_path / "store"))
    try:
        yield FactorizedMesh([1, 1], ("a", "b"))
    finally:
        torch.distributed.destroy_process_group()


def test_every_op_in_every_mode_in_a_world_of_one_rank(world_of_one):
    """The card's world (one NCCL rank there, one gloo rank here): size-1
    axes, so the rings post no hops and every op returns its input's
    values; no latency plan exists for n < 2."""
    mesh = world_of_one
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-64, 64, size=(64, 3)).astype(np.float32))
    with tapi.comm_context(mesh, ("a", "b")) as ctx:
        for mode in (None, "oneshot", "chunked", "perhop", "hybrid"):
            for op in (tapi.all_gather, tapi.reduce_scatter, tapi.all_reduce,
                       tapi.all_to_all):
                out = op(x, axis=0, mode=mode, num_chunks=4 if mode == "chunked" else None)
                assert torch.equal(out, x), (op.__name__, mode)
        assert {p.collective for p in ctx.plans()} == set(COLLS)
    with pytest.raises(ValueError, match="powers of two"):
        tapi.all_reduce(x, axis=0, ctx=tapi.CommContext(
            mesh, ("a", "b"), policy=tapi.PlanPolicy(regime="latency")))
