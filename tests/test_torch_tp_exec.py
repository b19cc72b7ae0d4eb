"""The port's tensor-parallel layer in an 8-rank gloo world, against the
reference on 8 fake devices and against numpy.

A module fixture runs two scripts at the same time (and ``launch.perf
--tp-block`` beside them), each in its own subprocess with a 240 s limit: ``tests/subproc/torch_tp_world.py`` (8
spawned gloo ranks, one thread each, meeting through a ``FileStore`` under
the test's temporary directory, with a 60 s timeout) and
``tests/subproc/torch_tp_ref.py`` (jax on 8 fake CPU devices, whose meshes
it asserts to be devices 0..7 in flat order).  Each writes one ``.npz`` of
outputs keyed by the cases of ``tests/subproc/torch_tp_cases.py``, on the
meshes [8] and [2, 4] (with the axis tuple in both orders):

* ``api.allgather_matmul`` (one weight and a pair) and
  ``api.matmul_reduce_scatter`` with fusion on, off and ``"auto"``, on
  integer-valued f32 inputs: bit for bit against the reference, against
  the unfused ``collective o matmul`` and against numpy, the gathered ``x``
  against ``api.all_gather``;
* their gradients (fused rings and planned collectives; with an
  ``api.all_to_all`` beside them) at atol 1e-5, and
  ``ffn_apply_tp_sp``'s and ``ffn_apply_tp``'s at 1e-4, against
  ``jax.grad`` of the reference (``tests/subproc/check_plan_executor.py``
  holds the reference's own at these tolerances); ``ffn_apply_tp`` against
  ``ffn_apply`` at 2e-5 (``tests/subproc/check_comms.py:257``);
* ``transformer_block_tp``, TP and SP, for a granite-like GQA config and
  configs with QKV biases and q/k norms, against the reference's
  ``shard_map`` block and ``transformer_block_ref`` at atol 2e-5 (the
  reference's own, ``src/repro/launch/perf.py:480``);
* ``sharded_decode_attention`` at four valid lengths (one leaves 7 of 8
  shards with no valid key) at 2e-5 (``check_comms.py:321``);
* ZeRO-1's scatter and gather, exact, with the summed fallback for a leaf
  that does not divide the data-parallel size and a slow axis.
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

import torch_tp_cases as C  # noqa: E402

TIMEOUT_S = 240
OP_ATOL = 1e-5
FFN_ATOL = 1e-4
BLOCK_ATOL = 2e-5


def _run(cmd, env):
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S, cwd=ROOT)
    if out.returncode != 0:
        raise AssertionError(
            f"{' '.join(map(str, cmd))} failed (rc {out.returncode})\n"
            f"--- stdout ---\n{out.stdout[-4000:]}\n--- stderr ---\n{out.stderr[-8000:]}")
    return out.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, reference, perf): the two scripts' outputs and ``launch.perf
    --tp-block``'s standard output, the three run side by side."""
    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TMPDIR=str(tmp))
    port, ref = tmp / "port.npz", tmp / "ref.npz"
    with ThreadPoolExecutor(3) as pool:
        jobs = [
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_tp_world.py"),
                               "--out", str(port), "--store", str(tmp)], env),
            pool.submit(_run, [sys.executable, str(SUBPROC / "torch_tp_ref.py"),
                               "--out", str(ref)], env),
            pool.submit(_run, [sys.executable, "-m", "repro_torch.launch.perf",
                               "--tp-block", "2,4", "--reps", "1", "--device", "cpu"], env),
        ]
        perf = [job.result() for job in jobs][2]
    with np.load(port) as p, np.load(ref) as r:
        yield {k: p[k] for k in p.files}, {k: r[k] for k in r.files}, perf


@pytest.fixture
def outputs(runs):
    return runs[:2]


def _ids(*kinds):
    return [c["id"] for c in C.CASES if c["kind"] in kinds]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _same_bits(a, b):
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _gathered(case, x):
    """numpy truth of the tiled all-gather of per-rank ``x`` on axis 1."""
    order = C.rank_blocks(case["mesh"], case["names"])
    return np.concatenate([x[r] for r in order], axis=1)


def _scattered(case, total, axis):
    """Each rank's block of ``total`` along ``axis``, stacked by rank."""
    idx = C.block_index(case["mesh"], case["names"])
    blocks = np.split(total, C.WORLD, axis=axis)
    return np.stack([blocks[idx[r]] for r in range(C.WORLD)])


@pytest.mark.parametrize("cid", _ids("ops"))
@pytest.mark.parametrize("ws", ("single", "pair"))
def test_allgather_matmul_bit_identical(outputs, cid, ws):
    port, ref = outputs
    case = C.case_by_id(cid)
    inp = C.inputs(case)
    g = _gathered(case, inp["x"])
    got_g = port[f"{cid}#g_{ws}"]
    assert _same_bits(got_g, np.broadcast_to(g, got_g.shape)), "gathered x != numpy"
    assert _same_bits(got_g, port[f"{cid}#ag"]), "gathered x != api.all_gather"
    assert _same_bits(got_g, ref[f"{cid}#g_{ws}"]), "gathered x != reference"
    outs = ("o_single",) if ws == "single" else ("o_pair0", "o_pair1")
    for i, key in enumerate(outs):
        got = port[f"{cid}#{key}"]
        want = np.stack([g @ inp[f"w{i}"][r] for r in range(C.WORLD)])
        assert _same_bits(got, want), f"{key} != numpy"
        assert _same_bits(got, port[f"{cid}#unfused{i}"]), f"{key} != all_gather @ w"
        assert _same_bits(got, ref[f"{cid}#{key}"]), f"{key} != reference"


@pytest.mark.parametrize("cid", _ids("ops"))
def test_matmul_reduce_scatter_bit_identical(outputs, cid):
    port, ref = outputs
    case = C.case_by_id(cid)
    inp = C.inputs(case)
    total = sum(inp["h"][r] @ inp["v"][r] for r in range(C.WORLD))
    got = port[f"{cid}#y"]
    assert _same_bits(got, _scattered(case, total, 1)), "!= numpy"
    assert _same_bits(got, port[f"{cid}#unfused_y"]), "!= reduce_scatter(h @ w)"
    assert _same_bits(got, ref[f"{cid}#y"]), "!= reference"


@pytest.mark.parametrize("cid", _ids("ops_grad", "ffn_sp_grad", "ffn_tp_grad"))
def test_gradients_match_jax_grad(outputs, cid):
    port, ref = outputs
    case = C.case_by_id(cid)
    atol = OP_ATOL if case["kind"] == "ops_grad" else FFN_ATOL
    keys = [k for k in port if k.startswith(cid + "#d")]
    assert {k for k in ref if k.startswith(cid + "#d")} == set(keys) and len(keys) >= 4
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=atol, err_msg=k)
    if case["kind"] == "ffn_tp_grad":
        # ffn_apply_tp against the reference's and against ffn_apply
        y = port[f"{cid}#y"]
        np.testing.assert_allclose(y, ref[f"{cid}#y"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(y, np.broadcast_to(ref[f"{cid}#full"], y.shape),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("cid", _ids("block"))
def test_transformer_block_tp_matches_reference(outputs, cid):
    port, ref = outputs
    case = C.case_by_id(cid)
    got = port[f"{cid}#out"]  # (8, B, S or S_local, d), rank order
    if case["sp"]:
        got = np.concatenate([got[r] for r in C.rank_blocks(case["mesh"], case["names"])],
                             axis=1)
    else:
        assert all(np.array_equal(got[0], got[r]) for r in range(C.WORLD)), \
            "TP ranks disagree on the replicated output"
        got = got[0]
    assert got.shape == ref[f"{cid}#ref"].shape
    np.testing.assert_allclose(got, ref[f"{cid}#out"], rtol=0, atol=BLOCK_ATOL,
                               err_msg="!= the reference's transformer_block_tp")
    np.testing.assert_allclose(got, ref[f"{cid}#ref"], rtol=0, atol=BLOCK_ATOL,
                               err_msg="!= transformer_block_ref on the full layer")
    assert (port[f"{cid}#plans"] > 0).all(), "the block planned no collective"


@pytest.mark.parametrize("valid", C.DECODE_VALID)
def test_sharded_decode_attention(outputs, valid):
    port, ref = outputs
    got = port[f"decode#out{valid}"]
    for r in range(C.WORLD):
        np.testing.assert_allclose(got[r], ref[f"decode#out{valid}"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got[r], ref[f"decode#truth{valid}"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("cid", _ids("zero1"))
def test_zero1_exact(outputs, cid):
    port, ref = outputs
    case = C.case_by_id(cid)
    inp = C.inputs(case)
    total_w, total_b = inp["g/w"].sum(0), inp["g/b"].sum(0)
    fast = C.block_index(case["mesh"], case["fast"])
    n_fast = int(fast.max()) + 1
    want_sc = np.stack([np.split(total_w, n_fast)[fast[r]] for r in range(C.WORLD)])
    for key, want in (("scattered_w", want_sc),
                      ("w", np.broadcast_to(total_w, (C.WORLD,) + total_w.shape)),
                      ("b", np.broadcast_to(total_b, (C.WORLD,) + total_b.shape))):
        assert _same_bits(port[f"{cid}#{key}"], want), f"{key} != numpy"
        assert _same_bits(port[f"{cid}#{key}"], ref[f"{cid}#{key}"]), f"{key} != reference"


def test_perf_tp_block_prints_every_row(runs):
    rows = [ln for ln in runs[2].splitlines()
            if ln.startswith("[perf/tp-block] ") and " fuse=" in ln]
    assert len(rows) == 2 * len(C.FUSES), rows
    for variant in ("tp", "sp"):
        for fuse in C.FUSES:
            (row,) = [r for r in rows if r.startswith(f"[perf/tp-block] {variant} fuse={fuse} ")]
            for field in ("plans=", "issued=", "modeled elec=", "optical=", "measured explicit=",
                          "gspmd=", "modes=", "cache="):
                assert field in row, (field, row)
            assert row.endswith("allclose=True"), row


def test_perf_needs_one_of_its_sections():
    from repro_torch.launch import perf

    with pytest.raises(SystemExit):
        perf.main(["--device", "cpu"])
    with pytest.raises(SystemExit):
        perf.main(["--collectives", "2,4", "--tp-block", "2,4", "--device", "cpu"])


def test_perf_tp_block_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour; this host has a CUDA device")
    from repro_torch.launch import perf

    with pytest.raises(RuntimeError, match="device='cpu'"):
        perf.main(["--tp-block", "2,4"])
