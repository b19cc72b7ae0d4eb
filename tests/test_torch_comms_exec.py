"""The port's collective executors in an 8-rank gloo world, bit for bit
against the reference's executors on 8 fake devices and against numpy.

A module fixture runs two scripts at the same time, each in its own
subprocess with a 240 s limit: ``tests/subproc/torch_comms_world.py``
(8 spawned gloo ranks, one thread each, meeting through a ``FileStore``
under the test's temporary directory, with a 60 s timeout) and
``tests/subproc/torch_comms_ref.py`` (jax on 8 fake CPU devices, whose
mesh it asserts to be devices 0..7 in flat order).  Each writes one
``.npz`` of outputs keyed by the cases of ``tests/subproc/
torch_comms_cases.py``: every collective (ag, rs, ar, a2a) in every mode
(planned, oneshot, chunked, perhop, hybrid, the latency exchange) on
meshes [2, 4] and [2, 2, 2], both stage orders of the cross-world search,
forced stage orders, the executors called with every stage a ring, and the
five baselines of ``collectives.py``.  Inputs are integer-valued float32,
so every sum is exact: one test per case compares the ``uint32`` views.
The world script also holds each output to the flat one-shot
``torch.distributed`` collective before it writes it.
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

import torch_comms_cases as C  # noqa: E402

TIMEOUT_S = 240


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
    tmp = tmp_path_factory.mktemp("comms")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    port, ref = tmp / "port.npz", tmp / "ref.npz"
    with ThreadPoolExecutor(2) as pool:
        jobs = [
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_comms_world.py"),
                               "--out", str(port), "--store", str(tmp)], env),
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_comms_ref.py"),
                               "--out", str(ref)], env),
        ]
        for job in jobs:
            job.result()
    with np.load(port) as p, np.load(ref) as r:
        yield {k: p[k] for k in p.files}, {k: r[k] for k in r.files}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("cid", C.CASE_IDS)
def test_case_bit_identical_to_reference_and_numpy(outputs, cid):
    port, ref = outputs
    case = C.case_by_id(cid)
    want = C.truth(case)
    got = port[cid]
    assert got.dtype == np.float32 and got.shape == want.shape, (got.shape, want.shape)
    assert ref[cid].shape == got.shape, (ref[cid].shape, got.shape)
    assert np.array_equal(_bits(got), _bits(ref[cid])), "port != reference executors"
    assert np.array_equal(_bits(got), _bits(want)), "port != numpy one-shot truth"


def test_cases_execute_every_mode(outputs):
    """The api cases executed plans of every mode, for every collective on
    both meshes, and the exchange chain for ag, rs and ar."""
    port, _ = outputs
    seen = {}
    for cid in C.CASE_IDS:
        if cid + "#plan" not in port:
            continue
        case = C.case_by_id(cid)
        plan = port[cid + "#plan"]
        assert all((row == plan[0]).all() for row in plan), f"{cid}: ranks ran different plans"
        mode = "exchange" if "exchange" in plan[0][2:] else str(plan[0][0])
        seen.setdefault((case["mesh"], case["op"]), set()).add(mode)
    for mesh in ("2x4", "2x2x2"):
        for op in C.COLLS:
            want = {"oneshot", "chunked", "perhop", "hybrid"} | (
                set() if op == "a2a" else {"exchange"})
            assert want <= seen[(mesh, op)], (mesh, op, seen[(mesh, op)])


def test_perf_collectives_prints_every_row(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    out = _run([sys.executable, "-m", "repro_torch.launch.perf", "--collectives", "2,4",
                "--sizes-kb", "1,64", "--reps", "1", "--device", "cpu",
                "--bench-json", str(tmp_path / "bench.json")], env)
    lines = out.splitlines()
    assert any("measured on host CPU under gloo" in ln for ln in lines)
    for kb in (1, 64):
        for coll in ("ag", "rs", "ar"):
            (row,) = [ln for ln in lines if ln.startswith(f"[perf/collectives] {coll} {kb}KB")]
            for mode in ("oneshot", "chunked", "perhop", "hybrid"):
                assert f" {mode}=" in row, (mode, row)
            assert "flat_oneshot=" in row and "optical=" in row and row.endswith("bit-identical")
            (lat,) = [ln for ln in lines if ln.startswith(f"[perf/latency] {coll} {kb}KB")]
            assert "exchange: elec=" in lat and "measured_auto=" in lat
    assert any(ln.startswith("[perf/latency] crossover") for ln in lines)
    assert any(ln.startswith("[perf/latency] cache: latency_plans=") for ln in lines)
    assert (tmp_path / "bench.json").is_file()


def test_perf_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour; this host has a CUDA device")
    from repro_torch.launch import perf

    with pytest.raises(RuntimeError, match="device='cpu'"):
        perf.main(["--collectives", "2,4", "--sizes-kb", "64"])
