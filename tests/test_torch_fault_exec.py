"""The port's fault layer in an 8-rank gloo world, against the reference's
on 8 fake devices.

A module fixture runs two scripts at the same time, each in its own
subprocess with a 240 s limit: ``tests/subproc/torch_fault_world.py`` (8
spawned gloo ranks, one thread each, meeting through a ``FileStore`` under
the test's temporary directory, with a 60 s timeout) and
``tests/subproc/torch_fault_ref.py`` (jax on 8 fake CPU devices).  Both
run the cases of ``tests/subproc/torch_fault_cases.py`` on the mesh [2, 4]
of ``tests/subproc/check_fault_tolerance.py``: ``execute_plan_verified``
under drops and corruptions on every collective, ring, exchange and
wavefront path, faults on one ring position (where the ranks' verdicts
disagree), then that script's api sections.  Outputs compare as ``uint32``
views; ``attempt_ok``, ``used_fallback``, ``stage_ok``, the injection's
``applied`` count and the plan compare rank by device.  The world also
asserts check_fault_tolerance.py's checks on every rank, one test each.
Also here: the fault layer in a world of one gloo rank, in this process.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SUBPROC = ROOT / "tests" / "subproc"
sys.path.insert(0, str(SUBPROC))

import torch_fault_cases as C  # noqa: E402

TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(cmd, env):
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S, cwd=ROOT)
    if out.returncode != 0:
        raise AssertionError(
            f"{' '.join(map(str, cmd))} failed (rc {out.returncode})\n"
            f"--- stdout ---\n{out.stdout[-4000:]}\n--- stderr ---\n{out.stderr[-8000:]}")
    return out.stdout


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(port, reference): the two scripts' outputs, run side by side."""
    tmp = tmp_path_factory.mktemp("fault")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    port, ref = tmp / "port.npz", tmp / "ref.npz"
    with ThreadPoolExecutor(2) as pool:
        jobs = [
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_fault_world.py"),
                               "--out", str(port), "--store", str(tmp)], env),
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_fault_ref.py"),
                               "--out", str(ref)], env),
        ]
        for job in jobs:
            job.result()
    with np.load(port) as p, np.load(ref) as r:
        yield {k: p[k] for k in p.files}, {k: r[k] for k in r.files}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _truth(op: str) -> np.ndarray:
    """The collective's exact result on every rank, (8, ...)."""
    x = C.inputs(op).astype(np.float64)
    n = C.WORLD
    if op == "ag":
        out = np.broadcast_to(x.reshape(-1), (n, x.size))
    elif op == "ar":
        out = np.broadcast_to(x.sum(0), x.shape)
    elif op == "rs":
        out = x.sum(0).reshape(n, -1)
    else:  # a2a: rank r's block j is rank j's block r
        out = x.reshape(n, n, -1).transpose(1, 0, 2).reshape(x.shape)
    return np.ascontiguousarray(out, dtype=np.float32)


@pytest.mark.parametrize("cid", C.VERIFIED_IDS)
def test_verified_output_bit_identical_to_reference_and_truth(outputs, cid):
    port, ref = outputs
    case = next(c for c in C.VERIFIED if c["id"] == cid)
    want = _truth(case["op"])
    assert port[cid].shape == ref[cid].shape == want.shape, (port[cid].shape, want.shape)
    assert np.array_equal(_bits(port[cid]), _bits(ref[cid])), "port != reference"
    assert np.array_equal(_bits(port[cid]), _bits(want)), "port != the exact collective"


@pytest.mark.parametrize("cid", C.VERIFIED_IDS)
def test_verified_diagnostics_equal_reference_per_rank(outputs, cid):
    """attempt_ok, used_fallback, stage_ok (where the path has stages),
    applied and the plan, rank r against device r."""
    port, ref = outputs
    keys = sorted(k for k in ref if k.startswith(cid + "#"))
    assert keys == sorted(k for k in port if k.startswith(cid + "#"))
    assert {f"{cid}#attempt_ok", f"{cid}#used_fallback", f"{cid}#applied"} <= set(keys)
    for key in keys:
        assert port[key].shape == ref[key].shape, (key, port[key].shape, ref[key].shape)
        assert np.array_equal(port[key], ref[key]), (key, port[key], ref[key])


def test_cases_cover_disagreement_fallback_and_recovery(outputs):
    """The case list exercises what it claims: a recovered retry, a
    fallback on every rank, and ranks that disagree on one attempt (an AG
    checksum is per rank; an RS stage's, and so an AR's, is the group
    total, so a fault on one ring position fails every rank of an AR)."""
    port, _ = outputs
    fell = {cid: port[f"{cid}#used_fallback"] for cid in C.VERIFIED_IDS}
    assert fell["ag-corrupt-forever"].all() and not fell["ag-drop-once"].any()
    for cid in ("ag-drop-once-device1", "ag-corrupt-forever-device3"):
        first = port[f"{cid}#attempt_ok"][:, 0]
        assert first.any() and not first.all(), (cid, first)
    assert fell["ag-corrupt-forever-device3"].any() and not fell["ag-corrupt-forever-device3"].all()
    assert fell["ar-corrupt-forever-device2"].all() and fell["ar-exchange-corrupt-device0"].all()
    assert "ag-hybrid-corrupt-forever#stage_ok" not in port  # wavefront: no stage probes
    assert port["ag-hybrid-corrupt-forever#applied"].min() == 4  # 2 chunks x 2 attempts


@pytest.mark.parametrize("name", C.CHECKS)
def test_world_check_passes_on_every_rank(outputs, name):
    port, _ = outputs
    verdicts = port["checks"][:, C.CHECKS.index(name)]
    assert verdicts.all(), f"{name}: failed on ranks {np.flatnonzero(~verdicts).tolist()}"


@pytest.mark.parametrize("key", C.API_OUTPUTS + ("trace-ag", "trace-ar"))
def test_api_output_bit_identical_to_reference(outputs, key):
    port, ref = outputs
    assert port[key].shape == ref[key].shape, (port[key].shape, ref[key].shape)
    assert np.array_equal(_bits(port[key]), _bits(ref[key]))


@pytest.mark.parametrize("stat", C.API_STATS)
def test_api_counter_equals_reference(outputs, stat):
    """The verify policy's fallbacks, the re-plans, the dead axis's plan and
    the trace loop's counters, equal on every rank and to the reference's."""
    port, ref = outputs
    i = C.API_STATS.index(stat)
    assert (port["api#stats"][:, i] == port["api#stats"][0, i]).all(), port["api#stats"][:, i]
    assert port["api#stats"][0, i] == ref["api#stats"][0, i]


# --------------------------------------------------------------------------
# a world of one gloo rank, in this process
# --------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=1, rank=0, store_path=str(tmp_path / "store"))
    try:
        yield FactorizedMesh([1, 1], ("a", "b"))
    finally:
        torch.distributed.destroy_process_group()


def test_verified_ops_in_a_world_of_one_rank(world_of_one):
    """The card's world: size-1 axes, no hops, so an injection finds
    nothing to hit; every verified op equals the plain one, nothing falls
    back, and a gradient flows through the verified dual collective."""
    from repro_torch.comms import FaultInjection, api, execute_plan_verified, fault_injection

    mesh = world_of_one
    x = torch.from_numpy(np.random.default_rng(0).integers(-8, 8, (64, 3)).astype(np.float32))
    ver = api.CommContext(mesh, ("a", "b"), policy=api.PlanPolicy(verify=True))
    plain = api.CommContext(mesh, ("a", "b"))
    with fault_injection(FaultInjection(axis="b", mode="corrupt", times=999)) as spec:
        for mode in (None, "oneshot", "chunked", "perhop", "hybrid"):
            for op in (api.all_gather, api.reduce_scatter, api.all_reduce, api.all_to_all):
                kw = dict(axis=0, mode=mode, num_chunks=4 if mode == "chunked" else None)
                assert torch.equal(op(x, ctx=ver, **kw), op(x, ctx=plain, **kw))
        plan = ver.plan("ag", 64 * 3 * 4.0, shape=(64, 3)).with_mode("perhop")
        out, diag = execute_plan_verified(x, plan, mesh=mesh, retries=2)
    assert spec.applied == 0 and ver.cache_stats.fallbacks == 0
    assert torch.equal(out, x)
    assert diag["attempt_ok"].tolist() == [True, True, True]
    assert not bool(diag["used_fallback"]) and diag["stage_ok"].shape == (3, 2)
    leaf = x.clone().requires_grad_(True)
    api.all_reduce(leaf, axis=0, ctx=ver).sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(x))


def test_fault_injection_and_retries_validate_as_the_reference():
    from repro.comms.plan_executor import execute_plan_verified as jver
    from repro.comms.ring_executor import FaultInjection as JFault
    from repro_torch.comms import FaultInjection, execute_plan_verified

    for cls in (JFault, FaultInjection):
        with pytest.raises(ValueError, match="drop|corrupt"):
            cls(axis="a", mode="flip")
        assert cls(axis="a") == cls(axis="a", hop=1, mode="drop", times=1,
                                    device=None, applied=0)
    for fn in (jver, execute_plan_verified):
        with pytest.raises(ValueError, match="retries must be >= 0"):
            fn(None, None, retries=-1)
