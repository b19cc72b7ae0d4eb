"""The port's spec-path training (``repro_torch.launch.train --mesh ...
--zero1 spec``: parameters, ZeRO-1 optimizer state and batch as DTensors
placed by the sharding specs) against the reference's launcher on 8 fake
devices.

A module fixture runs, side by side, each in its own subprocess with a
``TIMEOUT_S`` limit:

* ``tests/subproc/torch_spec_ref.py``, twice, each with a share of the
  runs of ``tests/subproc/torch_spec_cases.py`` (``REF_SPLIT``: most of
  its time is compiling, and two processes share it out over the cores):
  the reference's initial weights of the archs first, then its ``main()``
  on each run in turn (losses, output, final parameters, every device's
  shards of the final parameters and first moments), the resume and the
  refusals;
* ``tests/subproc/torch_spec_world.py``: ONE world of 8 gloo ranks that
  runs the port's ``launch.train.train`` on the same runs from the same
  weights, each as soon as its weights are written (losses, rank 0's output,
  the final parameters gathered whole, each rank's shards), and the resume.

The runs: reduced granite-3-2b on ``--mesh 2,4`` and ``2,2,2`` (3 steps),
reduced llama4-scout, rwkv6-7b and zamba2-2.7b on ``2,4`` (2 steps), all at
seq 16 (not 32, so that the file stays under a minute on one worker),
batch 8, f32; and granite on ``2,4`` trained 2 steps, then resumed
to 3.  Gates: the losses within ``LOSS_RTOL`` of the reference's, the final
parameters within ``PARAM_ATOL`` leaf by leaf, and on ``2,4`` each rank's
local shard of every parameter and first moment equal, in shape and within
``PARAM_ATOL``, to the reference's shard on the device of the same index.
The refusals come out word for word.  No check reads a clock.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launch_train

ROOT = Path(__file__).resolve().parents[1]
SUBPROC = ROOT / "tests" / "subproc"
sys.path.insert(0, str(SUBPROC))

import torch_spec_cases as C  # noqa: E402

TIMEOUT_S = 240
#: f32 training on 8 shards against 8 fake devices: the sums are taken in
#: other orders (measured: 1.8e-7 relative on the losses, 5.3e-6 on the
#: parameters)
LOSS_RTOL = 2e-5
PARAM_ATOL = 2e-5

NAMES = sorted(C.RUNS) + ["resume"]
#: the reference's runs in two processes: the granite runs with the resume
#: and the refusals, and the other families
REF_SPLIT = (["granite", "granite-pod", "--resume", "--refusals"],
             ["llama4", "rwkv6", "zamba2"])
assert sorted(n for part in REF_SPLIT for n in part if not n.startswith("--")) == sorted(C.RUNS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(cmd, env, log):
    with open(log, "w") as f:
        out = subprocess.run(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                             timeout=TIMEOUT_S, cwd=ROOT)
    text = Path(log).read_text()
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(map(str, cmd))} failed (rc {out.returncode})\n"
                             f"{text[-8000:]}")
    return text


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spec")
    ref, port = tmp / "ref", tmp / "port"
    ref.mkdir()
    port.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TMPDIR=str(tmp))
    with ThreadPoolExecutor(len(REF_SPLIT) + 1) as pool:
        jobs = [pool.submit(_run, [sys.executable, str(SUBPROC / "torch_spec_world.py"),
                                   "--inits", str(ref), "--out", str(port)],
                            env, tmp / "port.log")]
        for i, part in enumerate(REF_SPLIT):
            runs = ",".join(n for n in part if not n.startswith("--"))
            flags = [n for n in part if n.startswith("--")]
            jobs.append(pool.submit(_run, [sys.executable, str(SUBPROC / "torch_spec_ref.py"),
                                           "--out", str(ref), "--runs", runs] + flags,
                                    env, tmp / f"ref{i}.log"))
        port_out = [j.result() for j in jobs][0]
    yield ref, port, port_out


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _steps(name):
    if name == "resume":
        return C.RESUME_STEPS[1]
    return int(C.flag(C.RUNS[name], "--steps"))


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_reference(runs, name):
    ref, port, _ = runs
    want = json.loads((ref / f"{name}.json").read_text())["losses"]
    got = _npz(port / f"{name}_final.npz")["losses"]
    assert len(got) == len(want) == _steps(name)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_final_parameters_match_reference(runs, name):
    ref, port, _ = runs
    got = _npz(port / f"{name}_final.npz")
    want = _npz(ref / f"{name}_final.npz")
    init = _npz(ref / f"init_{C.arch(C.RESUME if name == 'resume' else C.RUNS[name])}.npz")
    assert set(want) == set(got) - {"losses"} == set(init)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL, err_msg=k)
    moved = [k for k in want if not np.array_equal(want[k], init[k])]
    assert len(moved) == len(want), "a leaf the step never updated"


@pytest.mark.parametrize("name", C.SHARDED)
def test_rank_shards_equal_reference_device_shards(runs, name):
    """Rank r holds, of every parameter and first moment, the slice device r
    of the reference's mesh holds: the placements and the device order."""
    ref, port, _ = runs
    want = _npz(ref / f"{name}_shards.npz")
    seen = set()
    for r in range(8):
        got = _npz(port / f"{name}_rank{r}.npz")
        assert len(got["losses"]) == _steps(name)
        for k, v in got.items():
            if k == "losses":
                continue
            w = want[f"{k}@{r}"]
            assert v.shape == w.shape, (k, r, v.shape, w.shape)
            np.testing.assert_allclose(v, w, rtol=0, atol=PARAM_ATOL, err_msg=f"{k}@{r}")
            seen.add(f"{k}@{r}")
    assert seen == set(want)
    # the placements split something: some shard is smaller than its leaf
    full = _npz(port / f"{name}_final.npz")
    assert any(want[f"{k}@0"].size < full[k.split("/", 1)[1]].size
               for k in {s.split("@")[0] for s in want} if k.startswith("params/"))


def _lines(text, prefix):
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def test_rank0_prints_each_run(runs):
    _, _, out = runs
    summaries = [json.loads(ln[len("[train/summary] "):]) for ln in _lines(out, "[train/summary] ")]
    first, total = C.RESUME_STEPS
    assert [len(s["losses"]) for s in summaries] == (
        [_steps(n) for n in C.RUNS] + [first, total - first])
    assert all(s["ranks"] == 8 for s in summaries)
    assert len(_lines(out, "step ")) == sum(_steps(n) for n in C.RUNS) + total
    assert _lines(out, "[train/resume] ") == [f"[train/resume] resumed from step {first}"]
    assert len(_lines(out, "mesh=")) == len(C.RUNS) + 2
    assert all(ln.endswith("zero1=spec") for ln in _lines(out, "mesh="))


@pytest.mark.parametrize("name", sorted(C.REFUSALS))
def test_refusals_match_reference(runs, name, tmp_path):
    ref, _, _ = runs
    want = json.loads((ref / "refusals.json").read_text())[name]
    try:
        launch_train.main(C.REFUSALS[name] + ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    except SystemExit as e:
        got = str(e.code)
    else:
        got = None
    assert want is not None and got == want
