"""The port's data-parallel training (``repro_torch.launch.train --mesh
--zero1 explicit``) against the reference's launcher on 8 fake devices.

A module fixture runs, side by side, each in its own subprocess with a
``TIMEOUT_S`` limit:

* ``tests/subproc/torch_dp_ref.py``, the reference's ``main()`` on 8 fake
  CPU devices, for each run of ``tests/subproc/torch_dp_cases.py`` (its
  initial and final parameters, its losses and its output) and for its
  refusals;
* ``tests/subproc/torch_dp_world.py``, the port's ``launch.train.train``
  in a world of gloo ranks from the reference's initial weights, started
  once the reference has written them (each rank's final parameters and
  losses, rank 0's output);
* ``torch_dp_world.py --run resume``: a ``--mesh 2,1`` world run unbroken,
  then resumed from a copy of its checkpoints.

The runs: reduced granite-3-2b on ``--mesh 2,4,1`` (pod 2, data 4) with
``--verify-collectives --fault-step 1``, and reduced llama4-scout (4
experts) with ``--expert-parallel`` on ``--mesh 4,1``; 3 steps of seq 32,
batch 8.  Per run: the losses within ``CURVE_LOSS_TOL`` and the final
parameters within ``CURVE_PARAM_TOL`` of the reference's
(``tests/test_torch_train.py``: measured, 8.8e-8 relative on the losses,
under a tenth of the parameter tolerance), every rank's parameters bit for
bit equal, and the plan sets equal: each cached plan's collective, shard
bytes, regime, mode, chunks and stage order, the health fingerprint,
``replans_on_fault`` and the plan count (the issue counts, cache hits and
fallback counts differ by design: see the launcher's docstring).  Also the
telemetry helpers line for line, the refusals word for word, and a world
resumed from a checkpoint equal to an unbroken run bit for bit.  No check
reads a clock.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launch_train
from test_torch_train import CURVE_LOSS_TOL, CURVE_PARAM_TOL

ROOT = Path(__file__).resolve().parents[1]
SUBPROC = ROOT / "tests" / "subproc"
sys.path.insert(0, str(SUBPROC))

import torch_dp_cases as C  # noqa: E402

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


def _held_run(name, tmp, env):
    """The reference's run ``name``, and the port's world from the initial
    weights the reference's launcher writes as it starts (the port's world
    starts once they are there, while the reference compiles its step)."""
    init = tmp / f"{name}_init.npz"
    extra = ["--refusals"] if name == "dense" else []
    with open(tmp / f"ref_{name}.log", "w") as log:
        ref = subprocess.Popen([sys.executable, str(SUBPROC / "torch_dp_ref.py"), "--run", name,
                                "--init", str(init), "--out", str(tmp)] + extra,
                               env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            port = None
            while ref.poll() is None and not init.exists():
                try:
                    ref.wait(0.1)
                except subprocess.TimeoutExpired:
                    pass
            if init.exists():
                port = _run([sys.executable, str(SUBPROC / "torch_dp_world.py"), "--run", name,
                             "--init", str(init), "--out", str(tmp)], env)
            rc = ref.wait(TIMEOUT_S)
        finally:
            ref.kill()
    assert rc == 0 and port is not None, (tmp / f"ref_{name}.log").read_text()[-8000:]
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TMPDIR=str(tmp))
    with ThreadPoolExecutor(len(C.RUNS) + 1) as pool:
        jobs = {f"port/{name}": pool.submit(_held_run, name, tmp, env) for name in C.RUNS}
        jobs["port/resume"] = pool.submit(
            _run, [sys.executable, str(SUBPROC / "torch_dp_world.py"), "--run", "resume",
                   "--out", str(tmp)], env)
        out = {k: job.result() for k, job in jobs.items()}
    yield tmp, out


def _ref(runs, name):
    tmp, _ = runs
    return json.loads((tmp / f"{name}.json").read_text())


def _port_ranks(runs, name):
    tmp, _ = runs
    ranks = []
    for r in range(C.world_size(C.RUNS[name])):
        with np.load(tmp / f"{name}_rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return ranks


def _lines(text, prefix):
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def _snapshot(text):
    (line,) = _lines(text, "[train/comms-json] ")
    return json.loads(line[len("[train/comms-json] "):])


# ---- (a) the telemetry helpers ------------------------------------------

def _contexts(api, planner, cost_model):
    """The meshless contexts of ``tests/test_launch.py``'s telemetry cases,
    built by one package: (name, context) after the same calls."""
    links = {"a": planner.LinkSpec("fast", 50e9, 1e-6), "b": planner.LinkSpec("slow", 1e9, 1e-5)}

    def ctx(**policy):
        return api.CommContext(axis_names=("a", "b"), links=links,
                               axis_sizes={"a": 2, "b": 4}, policy=api.PlanPolicy(**policy))

    plain = ctx()
    plain.plan("ag", 2**20)
    plain.plan("ar", 2**16)
    plain.plan("ag", 2**20)
    searched = ctx(order="optical",
                   optical=dataclasses.replace(cost_model.TERARACK, n_nodes=8, wavelengths=2))
    searched.plan("ag", 2**20)
    invalidated = ctx()
    invalidated.plan("ag", 2**20)
    invalidated.update_links({"a": planner.LinkSpec("fitted", 40e9, 2e-6)})
    regimes = ctx()
    regimes.plan("ar", 1024)
    regimes.plan("ar", 2**20)
    faulted = ctx()
    faulted.plan("rs", 2**18)
    faulted.report_fault(axis="b", derate=0.5)
    return {"plain": plain, "order-search": searched, "invalidated": invalidated,
            "regimes": regimes, "faulted": faulted}


@pytest.fixture(scope="module")
def contexts():
    from repro.comms import api as japi
    from repro.core import cost_model as jcost, planner as jplanner
    from repro_torch.comms import api
    from repro_torch.core import cost_model, planner

    return _contexts(japi, jplanner, jcost), _contexts(api, planner, cost_model)


@pytest.mark.parametrize("case", ["plain", "order-search", "invalidated", "regimes", "faulted"])
def test_comm_plan_telemetry_equals_reference(contexts, case):
    from repro.launch.train import comm_plan_telemetry as jtelemetry

    want = jtelemetry(contexts[0][case])
    assert launch_train.comm_plan_telemetry(contexts[1][case]) == want
    assert len(want) >= 2


@pytest.mark.parametrize("shape", [
    {"data": 4, "model": 1}, {"pod": 1, "data": 8, "model": 1},
    {"pod": 2, "data": 4, "model": 1}, {"pod": 4, "data": 2, "model": 1}])
@pytest.mark.parametrize("grad_bytes", [1.0, 5.07e9, 123456789.0])
def test_modeled_pod_traffic_note_equals_reference(shape, grad_bytes):
    from repro.launch.train import modeled_pod_traffic_note as jnote

    mesh = SimpleNamespace(shape=shape)
    assert launch_train.modeled_pod_traffic_note(grad_bytes, mesh) == jnote(grad_bytes, mesh)


# ---- (b), (c) the runs held to the reference ------------------------------

@pytest.mark.parametrize("name", sorted(C.RUNS))
def test_losses_match_reference(runs, name):
    want = _ref(runs, name)["losses"]
    for rank in _port_ranks(runs, name):
        assert len(rank["losses"]) == len(want) == int(C.flag(C.RUNS[name], "--steps"))
        np.testing.assert_allclose(rank["losses"], want, **CURVE_LOSS_TOL)
    assert np.isfinite(want).all()


@pytest.mark.parametrize("name", sorted(C.RUNS))
def test_final_parameters_match_reference(runs, name):
    tmp, _ = runs
    got = _port_ranks(runs, name)[0]
    with np.load(tmp / f"{name}_final.npz") as f, np.load(tmp / f"{name}_init.npz") as init:
        assert set(f.files) == set(got) - {"losses"}
        for k in f.files:
            np.testing.assert_allclose(got[k], f[k], err_msg=k, **CURVE_PARAM_TOL)
        moved = [k for k in f.files if not np.array_equal(f[k], init[k])]
    assert len(moved) == len(f.files), "a leaf the step never updated"


@pytest.mark.parametrize("name", sorted(C.RUNS))
def test_every_rank_holds_the_same_parameters(runs, name):
    ranks = _port_ranks(runs, name)
    assert len(ranks) == C.world_size(C.RUNS[name])
    for r, rank in enumerate(ranks[1:], 1):
        for k, v in ranks[0].items():
            assert np.array_equal(rank[k], v), (r, k)


@pytest.mark.parametrize("name", sorted(C.RUNS))
def test_plan_sets_match_reference(runs, name):
    _, out = runs
    got, want = _snapshot(out[f"port/{name}"]), _snapshot(_ref(runs, name)["stdout"])

    def plans(snap):
        return [{k: v for k, v in p.items() if k != "issued"} for p in snap["per_plan"]]

    assert plans(got) == plans(want) and len(plans(want)) >= 4
    assert {p["collective"] for p in plans(want)} >= {"rs", "ag"}
    for key in ("plans", "health_fp", "links_fp", "crossover_ar_bytes"):
        assert got[key] == want[key], key
    for key in ("misses", "invalidated", "replans_on_fault", "latency_plans", "ring_plans"):
        assert got["cache"][key] == want["cache"][key], key
    # eager: every step asks the context for every collective again
    steps = int(C.flag(C.RUNS[name], "--steps"))
    assert all(p["issued"] >= steps for p in got["per_plan"])


@pytest.mark.parametrize("name", sorted(C.RUNS))
def test_printed_lines_match_reference(runs, name):
    """The traffic note, the fault line (without its fallback count: the
    reference cannot count a fallback inside ``shard_map``), and the plan
    lines of the final telemetry without their issue counts."""
    _, out = runs
    got, want = out[f"port/{name}"], _ref(runs, name)["stdout"]
    assert _lines(got, "[train/zero1-explicit] ") == _lines(want, "[train/zero1-explicit] ")
    assert len(_lines(want, "[train/zero1-explicit] ")) == 2

    def no_fallbacks(lines):
        return [re.sub(r" fallbacks=\d+", "", ln) for ln in lines]

    assert no_fallbacks(_lines(got, "[train/fault] ")) == no_fallbacks(_lines(want, "[train/fault] "))
    if "--fault-step" in C.RUNS[name]:
        assert len(_lines(want, "[train/fault] ")) == 1

    def plan_lines(text):
        tail = text[text.index("final comm telemetry"):]
        return [re.sub(r" issued=x\d+", "", ln) for ln in _lines(tail, "[train/comms]   ")]

    assert plan_lines(got) == plan_lines(want)
    steps = _lines(got, "step ")
    assert len(steps) == int(C.flag(C.RUNS[name], "--steps"))


# ---- (d) a world resumed from a checkpoint --------------------------------

def _summary(text):
    (line,) = _lines(text, "[train/summary] ")
    return json.loads(line[len("[train/summary] "):])


def test_world_resume_equals_unbroken_run(runs):
    tmp, out = runs
    text = out["port/resume"]
    whole, cut = text[:text.index("[train/resume]")], text[text.index("[train/resume]"):]
    assert cut.startswith("[train/resume] resumed from step 2\n")
    want, got = _summary(whole)["losses"], _summary(cut)["losses"]
    assert len(want) == 4 and got == want[2:]
    assert _summary(cut)["ranks"] == 2
    with np.load(tmp / "whole" / "step_00000004" / "arrays_0.npz") as a, \
            np.load(tmp / "cut" / "step_00000004" / "arrays_0.npz") as b:
        assert set(a.files) == set(b.files)
        assert any(k.startswith("params/") for k in a.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    # rank 0 alone writes
    assert sorted(p.name for p in (tmp / "whole").iterdir()) == ["step_00000002", "step_00000004"]


# ---- (e) refusals ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(C.REFUSALS))
def test_refusals_match_reference(runs, name, tmp_path):
    tmp, _ = runs
    want = json.loads((tmp / "refusals.json").read_text())[name]
    argv = C.REFUSALS[name] + ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
    try:
        launch_train.main(argv)
    except SystemExit as e:
        got = str(e.code)
    except ValueError as e:
        got = f"ValueError: {e}"
    else:
        got = None
    assert want is not None and got == want


@pytest.mark.parametrize("argv,match", [
    (["--arch", "hubert-xlarge", "--mesh", "2,4"], "frame embeddings"),
    (["--zero1", "explicit"], "give it --mesh"),
])
def test_port_refuses_what_it_has_not_got(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        launch_train.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)] + argv)


@pytest.mark.parametrize("mesh", ["8", "2,2,2,1", "2,x"])
def test_mesh_takes_two_or_three_sizes(mesh, capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                           "--zero1", "explicit", "--mesh", mesh])
    assert "--mesh" in capsys.readouterr().err


def test_mesh_on_the_default_device_needs_cards():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour; this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "granite-3-2b", "--reduced", "--mesh", "2,1",
                           "--zero1", "explicit"])


# ---- the step on one rank ---------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=1, rank=0, store_path=str(tmp_path / "store"))
    try:
        yield FactorizedMesh([1, 1], ("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


def test_dp_step_on_one_rank_equals_the_single_device_step(world_of_one):
    """On one rank the explicit step is the plain step bit for bit: the
    reduce-scatter of one member is its input, nothing is gathered, and
    the division is by 1."""
    from repro_torch.comms.api import comm_context
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import init_params
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime import make_dp_train_step, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = reduced(get_config("granite-3-2b"))
    ocfg = OptimizerConfig(warmup_steps=1, decay_steps=3)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab_size, 16, 2))
    batches = [{k: torch.from_numpy(v) for k, v in next(pipe).items()} for _ in range(2)]
    results = []
    with comm_context(world_of_one, ("data",)) as ctx:
        for step in (make_train_step(cfg, ocfg),
                     make_dp_train_step(cfg, ocfg, world_of_one, ("data",), ctx=ctx)):
            params = init_params(cfg, seed=0, device="cpu")
            opt = adamw_init(params, ocfg)
            losses = []
            for b in batches:
                params, opt, m = step(params, opt, b)
                losses.append(float(m["loss"]))
            results.append((losses, tree_leaves(params), tree_leaves(opt)))
    (l0, p0, o0), (l1, p1, o1) = results
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0 + o0, p1 + o1))
    assert {p.collective for p in ctx.plans()} == {"rs"}


def test_dp_axes_match_reference():
    from repro.models.sharding import dp_axes as jdp_axes
    from repro_torch.models.sharding import dp_axes

    for shape in ({"data": 2, "model": 4}, {"pod": 2, "data": 4, "model": 1}, {"model": 8}):
        mesh = SimpleNamespace(shape=shape)
        assert dp_axes(mesh) == jdp_axes(mesh)


def test_trainer_writes_no_checkpoint_unless_it_is_the_writer(tmp_path):
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import init_params
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = reduced(get_config("granite-3-2b"))
    ocfg = OptimizerConfig(warmup_steps=1, decay_steps=2)
    for sub, interval, writer in (("reader", 1, False), ("none", 0, True), ("writer", 1, True)):
        params = init_params(cfg, seed=0, device="cpu")
        tr = Trainer(cfg, ocfg, TrainerConfig(total_steps=2, ckpt_interval=interval,
                                              ckpt_dir=str(tmp_path / sub)),
                     params=params, opt_state=adamw_init(params, ocfg),
                     pipeline=SyntheticLMPipeline(DataConfig(cfg.vocab_size, 8, 2)),
                     writer=writer)
        assert tr.run()["final_step"] == 2
        saved = sorted(p.name for p in (tmp_path / sub).iterdir())
        assert saved == (["step_00000001", "step_00000002"] if sub == "writer" else []), sub
