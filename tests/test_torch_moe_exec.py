"""The port's expert-parallel MoE block in an 8-rank gloo world, against the
reference on 8 fake devices.

A module fixture runs two scripts at the same time, each in its own
subprocess with a 240 s limit: ``tests/subproc/torch_moe_world.py`` (8
spawned gloo ranks, one thread each, meeting through a ``FileStore`` under
the test's temporary directory, with a 60 s timeout) and
``tests/subproc/torch_moe_ref.py`` (jax on 8 fake CPU devices, whose meshes
it asserts to be devices 0..7 in flat order).  Each writes one ``.npz`` of
outputs keyed by the cases of ``tests/subproc/torch_moe_cases.py``:
``tests/subproc/check_plan_executor.py``'s MoE config (d 16, 16 experts,
top-2, a shared expert) with the experts over the mesh [8] (axis "ep") and
over either factor of the mesh [2, 4], at a size with one token a group and
at one whose experts overflow.

* the expert-parallel output against the reference's ``shard_map`` block
  and against the port's one-device block run rank by rank, at 1e-5 (the
  reference's own exact check of this fails, ROADMAP queue C);
* the aux losses, means over the expert axis, at 1e-5;
* the gradients, summed over ranks, against ``jax.grad`` at 1e-5;
* the all-to-all plans the context issued, equal to the reference's;
* ``torch_moe_world.py --suite full`` (the card machine's ``[moe/gloo8]``)
  at reduced width.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SUBPROC = ROOT / "tests" / "subproc"
sys.path.insert(0, str(SUBPROC))

import torch_moe_cases as C  # noqa: E402

TIMEOUT_S = 240
TOL = dict(rtol=1e-5, atol=1e-5)


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
    tmp = tmp_path_factory.mktemp("moe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TMPDIR=str(tmp))
    port, ref = tmp / "port.npz", tmp / "ref.npz"
    with ThreadPoolExecutor(2) as pool:
        jobs = [
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_moe_world.py"),
                               "--out", str(port), "--store", str(tmp)], env),
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_moe_ref.py"),
                               "--out", str(ref)], env),
        ]
        for job in jobs:
            job.result()
    with np.load(port) as p, np.load(ref) as r:
        yield {k: p[k] for k in p.files}, {k: r[k] for k in r.files}


def _ids(kind):
    return [c["id"] for c in C.CASES if c["kind"] == kind]


def _global(per_rank):
    """(8, b, S, d) rank-stacked rows -> the global (8 b, S, d) array."""
    return per_rank.reshape((-1,) + per_rank.shape[2:])


@pytest.mark.parametrize("cid", _ids("fwd"))
def test_expert_parallel_block_matches_reference(outputs, cid):
    port, ref = outputs
    got = _global(port[f"{cid}#out"])
    assert got.shape == ref[f"{cid}#out"].shape
    np.testing.assert_allclose(got, ref[f"{cid}#out"], err_msg="!= the reference's EP block",
                               **TOL)
    np.testing.assert_allclose(got, _global(port[f"{cid}#local"]),
                               err_msg="!= the port's one-device block, rank by rank", **TOL)
    np.testing.assert_allclose(got, ref[f"{cid}#local"],
                               err_msg="!= the reference's one-device block", **TOL)
    for k in ("lb", "rz"):
        np.testing.assert_allclose(port[f"{cid}#{k}"], ref[f"{cid}#{k}"], err_msg=k, **TOL)


@pytest.mark.parametrize("cid", _ids("fwd"))
def test_aux_losses_are_means_over_the_expert_axis(outputs, cid):
    """Each rank's aux equals the mean, over the ranks sharing its
    coordinates off the expert axis, of the one-device block's aux."""
    port, _ = outputs
    case = C.case_by_id(cid)
    factors, names = C.MESHES[case["mesh"]]
    coords = np.stack(np.unravel_index(np.arange(C.WORLD), factors), axis=1)
    others = [i for i, n in enumerate(names) if n != case["axis"]]
    for k in ("lb", "rz"):
        vals = port[f"{cid}#{k}"]
        for r in range(C.WORLD):
            peers = [s for s in range(C.WORLD)
                     if all(coords[s, i] == coords[r, i] for i in others)]
            assert len(peers) == factors[names.index(case["axis"])]
            np.testing.assert_allclose(vals[r], vals[peers].mean(), **TOL)


@pytest.mark.parametrize("cid", _ids("grad"))
def test_expert_parallel_gradients_match_jax_grad(outputs, cid):
    port, ref = outputs
    keys = sorted(k for k in ref if k.startswith(cid + "#d"))
    assert keys == sorted(k for k in port if k.startswith(cid + "#d")) and len(keys) == 8
    for k in keys:
        got = _global(port[k]) if k.endswith("#dx") else port[k].sum(0)
        np.testing.assert_allclose(got, ref[k], err_msg=k, **TOL)
        assert np.abs(ref[k]).max() > 0, k


@pytest.mark.parametrize("cid", _ids("fwd"))
def test_all_to_all_plans_match_reference(outputs, cid):
    port, ref = outputs
    want = ref[f"{cid}#plans"]
    assert len(want) >= 1 and all('"a2a"' in p for p in want)
    for r in range(C.WORLD):
        assert list(port[f"{cid}#plans"][r]) == list(want), r


def test_overflow_cases_drop_tokens():
    """The "overflow" size does overflow: some (token, choice) pairs of
    each rank find their expert full."""
    import torch

    from repro_torch.configs import ModelConfig, MoEConfig
    from repro_torch.models.moe import _num_groups

    case = C.case_by_id("fwd-8-ep-overflow")
    inp = C.inputs(case)
    cfg = ModelConfig(**C.CONFIG, moe=MoEConfig(**C.MOE))
    B, S, d = inp["x"].shape
    T = B // C.WORLD * S
    G = _num_groups(T)
    Tg, K, E = T // G, cfg.moe.top_k, cfg.moe.num_experts
    cap = int(np.ceil(K * Tg / E * cfg.moe.capacity_factor))
    x = torch.from_numpy(inp["x"][:B // C.WORLD]).reshape(G, Tg, d)
    ids = torch.topk(x @ torch.from_numpy(inp["p/router/w"]), K, dim=-1).indices
    counts = torch.nn.functional.one_hot(ids.reshape(G, -1), E).sum(1)
    assert int(counts.max()) > cap


def test_full_suite_at_reduced_width(tmp_path):
    """The card machine's ``[moe/gloo8]`` suite (experts over the mesh [8],
    2 a rank, each held as a local shard, against the one-device block on
    rank 0) at d 64: one row, within its limit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    out = _run([sys.executable, str(SUBPROC / "torch_moe_world.py"), "--suite", "full",
                "--reduced", "--reps", "1", "--store", str(tmp_path)], env)
    rows = [ln for ln in out.splitlines() if ln.startswith("[moe/gloo8] ")]
    assert len(rows) == 1 and rows[0].endswith(" ok"), out
    assert "plans ['a2a:perhop'] issued 2" in rows[0], rows[0]
