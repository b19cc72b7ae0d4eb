"""The port's training path against the JAX package on the CPU.

Reduced configs in f32.  The reference's ``init_params`` tree is turned
into numpy and handed to both packages: as jax arrays to the reference and
through ``from_jax_params`` to the port.  Batches come from each package's
``SyntheticLMPipeline`` (the same numpy code, so the same tokens).

* ``loss_fn`` and every gradient leaf agree within 1e-5 (relative and
  absolute), under the reference's ``ref`` backend and once under its
  Pallas kernels in interpret mode, with the loss split into chunks and a
  padded vocabulary, and with per-layer remat; one step of loss and
  gradient on reduced rwkv6-7b, zamba2-2.7b and phi-3-vision (with an
  image prefix) too.
* A 5-step ``Trainer`` run: losses and final parameters within the
  tolerances ``CURVE_LOSS_TOL`` and ``CURVE_PARAM_TOL`` (below).
* ``adamw_update`` on a random tree (clip, bf16 parameters with an f32
  master, bf16 moments), ``cosine_lr``, the pipeline's batches (equal),
  and ``replan`` (equal).
* The checkpointer: save, restore (a bf16 leaf bit for bit) and garbage
  collection, a delete cut short, and a train run killed with SIGKILL
  after its second committed save, then resumed.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.data import DataConfig as JDataConfig, SyntheticLMPipeline as JPipeline
from repro.kernels import ops as jops
from repro.models import init_params as jinit_params, loss_fn as jloss_fn
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import adamw_init as jadamw_init, adamw_update as jadamw_update
from repro.optim import cosine_lr as jcosine_lr
from repro.runtime.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro.runtime.trainer import replan as jreplan
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import from_jax_params, init_params, loss_fn
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.runtime import Trainer, TrainerConfig, make_train_step, replan
from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
#: 5 AdamW steps from the same init and batches.  The losses agreed within
#: 7.2e-8 relative.  Adam divides each gradient by its running RMS, so where
#: a gradient element is near 0, m/sqrt(v) turns a last-bit difference into
#: a step difference of up to lr (3e-4 here): 2 of 106,816 parameters moved
#: by more than 1e-6, the largest by 3.9e-6.
CURVE_LOSS_TOL = dict(rtol=1e-6, atol=0)
CURVE_PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
#: loss_chunk 8 splits S 32 into 4 chunks; vocab 250 pads to 256
LOSS_CFG = dict(loss_chunk=8, vocab_size=250)
WEIGHT_MUL = 10.0  # the gradients of the 0.02 init are too small to hold at 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(arch, mul=1.0, **changes):
    """(jax cfg, jax params, port cfg, port params) with the same weights;
    every weight but the norms' scales multiplied by ``mul``."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (1.0 if path[-1].key == "scale" else mul),
        jinit_params(jax.random.key(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, device="cpu")


def _batch(vocab, seq=32, batch=2, step=0):
    return SyntheticLMPipeline(DataConfig(vocab_size=vocab, seq_len=seq,
                                          global_batch=batch))._batch_at(step)


def _ref_layout(tree):
    """The port's tree as numpy leaves keyed like the reference's (layers
    stacked on a leading axis)."""
    tree = tree_map(lambda a: a.detach().float().numpy(), tree)
    layers = tree.pop("layers")
    tree["layers"] = tree_map(lambda *xs: np.stack(xs), layers[0], *layers[1:])
    return tree_flatten_with_keys(tree)


def _jax_flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a, dtype=np.float32)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _loss_and_grads(cfg, params, batch):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, _ = loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return float(loss.detach()), tree_map(lambda _: next(grads), params)


@pytest.mark.parametrize("backend,changes", [
    pytest.param("ref", LOSS_CFG, id="ref-chunked-padded-vocab"),
    pytest.param("pallas", LOSS_CFG, id="pallas-interpret"),
    pytest.param("ref", dict(LOSS_CFG, remat=True), id="ref-remat"),
    pytest.param("ref", {}, id="ref-one-chunk"),
])
def test_granite_loss_and_gradients_match_reference(backend, changes):
    jcfg, jp, cfg, tp = _models("granite-3-2b", WEIGHT_MUL, **changes)
    batch = _batch(cfg.vocab_size)
    with jops.backend_scope(backend):  # pallas: interpret mode on the CPU
        (jl, jm), jg = jax.value_and_grad(
            lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True)(jp)
    loss, grads = _loss_and_grads(cfg, tp, batch)
    np.testing.assert_allclose(loss, float(jl), **GRAD_TOL)
    _assert_trees_close(_ref_layout(grads), _jax_flat(jg), **GRAD_TOL)
    assert float(jm["ce"]) == pytest.approx(float(jl))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_recurrent_loss_and_gradients_match_reference(arch):
    jcfg, jp, cfg, tp = _models(arch, **LOSS_CFG)
    batch = _batch(cfg.vocab_size, seq=16)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, grads = _loss_and_grads(cfg, tp, batch)
    np.testing.assert_allclose(loss, float(jl), **GRAD_TOL)
    _assert_trees_close(_ref_layout(grads), _jax_flat(jg), **GRAD_TOL)


def test_granite_remat_dots_matches_full_and_reference():
    """``remat_policy="dots"``: the loss and every gradient equal
    ``"full"``'s at 1e-6 and the reference's (``jax.checkpoint`` under
    ``checkpoint_dots_with_no_batch_dims``) at 1e-5; the backward recomputes
    fewer matrix products than under ``"full"``, which recomputes them all."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    batch = _batch(LOSS_CFG["vocab_size"])
    jcfg, jp, dcfg, tp = _models("granite-3-2b", WEIGHT_MUL, remat=True,
                                 remat_policy="dots", **LOSS_CFG)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    counts = {}
    results = {}
    for policy in ("dots", "full"):
        cfg = dataclasses.replace(dcfg, remat_policy=policy)
        with CountMM() as mode:
            results[policy] = _loss_and_grads(cfg, tree_map(lambda a: a.detach().clone(), tp),
                                              batch)
        counts[policy] = mode.mm
    (loss, grads), (full_loss, full_grads) = results["dots"], results["full"]
    np.testing.assert_allclose(loss, full_loss, rtol=1e-6, atol=1e-6)
    _assert_trees_close(_ref_layout(grads), _ref_layout(full_grads), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loss, float(jl), **GRAD_TOL)
    _assert_trees_close(_ref_layout(grads), _jax_flat(jg), **GRAD_TOL)
    assert counts["dots"] < counts["full"], counts


def test_loss_refuses_what_is_not_ported():
    """Every family of the registry is ported; a family outside it raises."""
    cfg = reduced(get_config("granite-3-2b"))
    params = init_params(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, seq=8).items()}
    with pytest.raises(ValueError, match="unknown family"):
        loss_fn(dataclasses.replace(cfg, family="diffusion"), params, batch)
    vlm = dataclasses.replace(reduced(get_config("phi-3-vision-4.2b")), vocab_size=256)
    vparams = init_params(vlm, device="cpu")
    assert vlm.family == "vlm" and bool(torch.isfinite(loss_fn(vlm, vparams, batch)[0]))


def test_vlm_loss_and_gradients_match_reference():
    """Reduced phi-3-vision with an image prefix over the first positions,
    the loss in chunks over a padded vocabulary: the loss and every
    gradient at 1e-5, the embedding rows under the prefix included."""
    jcfg, jp, cfg, tp = _models("phi-3-vision-4.2b", WEIGHT_MUL, **LOSS_CFG)
    batch = dict(_batch(cfg.vocab_size))
    batch["image_embeds"] = np.random.default_rng(6).normal(
        size=(2, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jp)
    loss, grads = _loss_and_grads(cfg, tp, batch)
    np.testing.assert_allclose(loss, float(jl), **GRAD_TOL)
    _assert_trees_close(_ref_layout(grads), _jax_flat(jg), **GRAD_TOL)


def test_moe_loss_under_remat_matches_reference():
    """Reduced llama4-scout with per-layer remat: the loss, its
    load-balance and router-z terms and every gradient at 1e-5 (the aux
    losses summed over the layers under checkpointing)."""
    jcfg, jp, cfg, tp = _models("llama4-scout-17b-a16e", WEIGHT_MUL, remat=True, **LOSS_CFG)
    batch = _batch(cfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss, metrics = loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, tree_leaves(tp)))
    got = tree_map(lambda _: next(grads), tp)
    assert set(metrics) == set(jm) == {"ce", "load_balance", "router_z", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), err_msg=k,
                                   **GRAD_TOL)
    _assert_trees_close(_ref_layout(got), _jax_flat(jg), **GRAD_TOL)


def test_loss_refuses_an_unknown_remat_policy():
    cfg = dataclasses.replace(reduced(get_config("granite-3-2b")), remat=True,
                              remat_policy="dot")
    params = init_params(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, seq=8).items()}
    with pytest.raises(ValueError, match="remat_policy 'dot'"):
        loss_fn(cfg, params, batch)


def test_trainer_five_steps_match_reference(tmp_path):
    jcfg, jp, cfg, tp = _models("granite-3-2b", WEIGHT_MUL)
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    ocfg = dict(warmup_steps=2, decay_steps=5)
    jtr = JTrainer(jcfg, JOptimizerConfig(**ocfg),
                   JTrainerConfig(total_steps=5, ckpt_interval=100, ckpt_dir=str(tmp_path / "j")),
                   params=jp, opt_state=jadamw_init(jp), pipeline=JPipeline(JDataConfig(**dcfg)))
    tr = Trainer(cfg, OptimizerConfig(**ocfg),
                 TrainerConfig(total_steps=5, ckpt_interval=100, ckpt_dir=str(tmp_path / "t")),
                 params=tp, opt_state=adamw_init(tp), pipeline=SyntheticLMPipeline(DataConfig(**dcfg)))
    want, got = jtr.run(), tr.run()
    assert got["final_step"] == want["final_step"] == 5
    np.testing.assert_allclose(got["losses"], want["losses"], **CURVE_LOSS_TOL)
    assert got["losses"][-1] < got["losses"][0]
    _assert_trees_close(_ref_layout(tr.params), _jax_flat(jtr.params), **CURVE_PARAM_TOL)


def test_trainer_resume_is_bit_exact(tmp_path):
    """4 steps and a save, a fresh trainer restored from it, 2 more steps:
    the same losses and parameters as 6 unbroken steps."""
    cfg = reduced(get_config("granite-3-2b"))
    ocfg = OptimizerConfig(warmup_steps=2, decay_steps=6)

    def trainer(steps, ckpt_dir):
        params = init_params(cfg, seed=0, device="cpu")
        return Trainer(cfg, ocfg, TrainerConfig(total_steps=steps, ckpt_interval=4,
                                                ckpt_dir=str(ckpt_dir)),
                       params=params, opt_state=adamw_init(params, ocfg),
                       pipeline=SyntheticLMPipeline(DataConfig(cfg.vocab_size, 16, 2)))

    whole = trainer(6, tmp_path / "whole")
    want = whole.run()["losses"]
    first = trainer(4, tmp_path / "cut")
    got = first.run()["losses"]
    second = trainer(6, tmp_path / "cut")
    assert second.try_restore() and second.step == 4
    got += second.run()["losses"]
    assert got == want
    for a, b in zip(tree_leaves(second.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(second.opt_state), tree_leaves(whole.opt_state)):
        assert torch.equal(a, b)


def _random_tree(rng, scale):
    return {"a": rng.normal(size=(8, 16)).astype(np.float32) * scale,
            "b": {"c": rng.normal(size=(5,)).astype(np.float32) * scale,
                  "d": rng.normal(size=(3, 4)).astype(np.float32) * scale}}


@pytest.mark.parametrize("param_dtype,grad_scale,ocfg", [
    pytest.param("float32", 10.0, {}, id="f32-clipped"),
    pytest.param("float32", 0.01, {}, id="f32-unclipped"),
    pytest.param("bfloat16", 10.0, {}, id="bf16-params-f32-master"),
    pytest.param("bfloat16", 10.0, dict(state_dtype="bfloat16", use_master=False),
                 id="bf16-params-bf16-moments-no-master"),
])
def test_adamw_update_matches_reference(param_dtype, grad_scale, ocfg):
    rng = np.random.default_rng(0)
    init = _random_tree(rng, 1.0)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(param_dtype), init)
    params = tree_map(lambda a: torch.from_numpy(a).to(getattr(torch, param_dtype)), init)
    jcfg = JOptimizerConfig(warmup_steps=2, decay_steps=10, **ocfg)
    cfg = OptimizerConfig(warmup_steps=2, decay_steps=10, **ocfg)
    jstate, state = jadamw_init(jparams, jcfg), adamw_init(params, cfg)
    for _ in range(3):
        g = _random_tree(rng, grad_scale)
        jparams, jstate = jadamw_update(jax.tree.map(lambda a: jnp.asarray(a).astype(param_dtype), g),
                                        jstate, jparams, jcfg)
        params, state = adamw_update(
            tree_map(lambda a: torch.from_numpy(a).to(getattr(torch, param_dtype)), g),
            state, params, cfg)
    assert int(state["step"]) == int(jstate["step"]) == 3
    # bf16 leaves may round the other way at the last bit: one bf16 ulp
    tol = dict(rtol=2**-8, atol=0) if param_dtype == "bfloat16" else dict(rtol=1e-6, atol=1e-7)
    for a in tree_leaves(params):
        assert a.dtype == getattr(torch, param_dtype)
    _assert_trees_close(tree_flatten_with_keys(tree_map(lambda a: a.float().numpy(), params)),
                        _jax_flat(jparams), **tol)
    for key in ("m", "v") + (("master",) if cfg.use_master else ()):
        mtol = dict(rtol=2**-8, atol=1e-12) if key != "master" and ocfg else dict(rtol=1e-6, atol=1e-9)
        _assert_trees_close(tree_flatten_with_keys(tree_map(lambda a: a.float().numpy(), state[key])),
                            _jax_flat(jstate[key]), **mtol)


def test_cosine_lr_matches_reference():
    for kw in (dict(warmup_steps=5, decay_steps=20), dict(warmup_steps=0, decay_steps=3)):
        jcfg, cfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
        got = [float(cosine_lr(cfg, s)) for s in range(30)]
        want = [float(jcosine_lr(jcfg, jnp.asarray(s, jnp.int32))) for s in range(30)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert cosine_lr(cfg, 3).dtype == torch.float32


@pytest.mark.parametrize("hosts,host_id", [(1, 0), (2, 1)])
def test_pipeline_batches_equal_reference(hosts, host_id):
    kw = dict(vocab_size=300, seq_len=24, global_batch=4, seed=3, num_hosts=hosts,
              host_id=host_id)
    jpipe, pipe = JPipeline(JDataConfig(**kw)), SyntheticLMPipeline(DataConfig(**kw)).start()
    try:
        for _ in range(5):
            a, b = next(jpipe), next(pipe)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert pipe.state() == jpipe.state()
        pipe.restore({"step": 2, "seed": 3})
        jpipe.restore({"step": 2, "seed": 3})
        np.testing.assert_array_equal(next(pipe)["tokens"], next(jpipe)["tokens"])
    finally:
        pipe.stop()


@pytest.mark.parametrize("world", [64, 256])
def test_replan_matches_reference(world):
    got, want = replan(world, 4 * 2**20), jreplan(world, 4 * 2**20)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert np.prod(got.factors) == world


def _state():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 8, generator=gen).to(torch.bfloat16),
                       "layers": [{"b": torch.randn(3, generator=gen)} for _ in range(2)]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)},
            "data_state": {"step": 5, "seed": 0}}


def test_checkpointer_round_trip_keeps_bits(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = _state()
    ck.save(3, state)
    template = tree_map(lambda a: torch.zeros_like(a) if isinstance(a, torch.Tensor) else 0,
                        state)
    step, got = ck.restore(template)
    assert step == 3
    w = got["params"]["w"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(w.view(torch.int16), state["params"]["w"].view(torch.int16))
    assert torch.equal(got["params"]["layers"][1]["b"], state["params"]["layers"][1]["b"])
    assert int(got["opt"]["step"]) == 7 and got["opt"]["step"].dtype == torch.int32
    assert int(got["data_state"]["step"]) == 5
    meta = (tmp_path / "step_00000003" / "meta.json").read_text()
    assert '"params/w": "bfloat16"' in meta


def test_checkpointer_gc_keeps_the_latest(tmp_path):
    committed = []
    ck = Checkpointer(tmp_path, keep=2, on_commit=lambda s, p: committed.append(s))
    state = _state()
    for s in (2, 4, 6, 8):
        ck.save(s, state, blocking=False)
        state["params"]["layers"][0]["b"].add_(1.0)  # the save holds its own copy
    ck.wait()
    assert committed == [2, 4, 6, 8]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000006", "step_00000008"]
    assert ck.latest_step() == 8
    _, got = ck.restore(_state(), step=6)
    assert torch.equal(got["params"]["layers"][0]["b"], _state()["params"]["layers"][0]["b"] + 2)
    ck.save(8, state)  # a same-step re-save replaces the committed one
    assert ck.latest_step() == 8


def test_checkpointer_gc_cut_short_leaves_no_torn_step(tmp_path, monkeypatch):
    """A kill in the middle of a delete: the files are gone but the
    directory is not.  The step being deleted was renamed out of sight
    first, so every visible ``step_*`` is complete, and the next save
    sweeps the remains."""
    ck = Checkpointer(tmp_path, keep=1)
    ck.save(2, _state())
    real_rmtree = ckpt_mod.shutil.rmtree

    def cut_rmtree(path, ignore_errors=False):
        for f in Path(path).iterdir():
            f.unlink()
        raise KeyboardInterrupt("killed mid-delete")

    monkeypatch.setattr(ckpt_mod.shutil, "rmtree", cut_rmtree)
    with pytest.raises(KeyboardInterrupt):
        ck.save(4, _state())
    monkeypatch.setattr(ckpt_mod.shutil, "rmtree", real_rmtree)
    visible = [p for p in tmp_path.glob("step_*") if not p.name.endswith(".tmp")]
    assert [p.name for p in visible] == ["step_00000004"]
    assert all((p / "meta.json").exists() for p in visible)
    assert Checkpointer(tmp_path).latest_step() == 4
    ck.save(6, _state())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000006"]


def _train_cmd(ckpt_dir, steps, resume=False):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-3-2b",
           "--reduced", "--device", "cpu", "--seq", "16", "--batch", "2",
           "--steps", str(steps), "--log-every", "1",
           "--ckpt-dir", str(ckpt_dir), "--ckpt-interval", "2"]
    return cmd + (["--resume"] if resume else [])


def test_resume_after_kill(tmp_path):
    """SIGKILL a checkpointing train run once it has printed its second
    committed save; every ``step_*`` left must be complete, and
    ``--resume`` must continue from the latest."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ckpt = tmp_path / "ckpt"
    proc = subprocess.Popen(_train_cmd(ckpt, 500), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(300, proc.kill)  # a hung child fails the test, never hangs it
    watchdog.start()
    seen = []
    try:
        for line in proc.stdout:
            seen.append(line)
            if sum(ln.startswith("[train/ckpt] committed") for ln in seen) == 2:
                proc.send_signal(signal.SIGKILL)
                break
    finally:
        proc.kill()
        proc.wait(timeout=60)
        watchdog.cancel()
    assert sum(ln.startswith("[train/ckpt] committed") for ln in seen) == 2, "".join(seen)

    survivors = [p for p in ckpt.glob("step_*") if not p.name.endswith(".tmp")]
    assert survivors
    for p in survivors:
        assert (p / "meta.json").exists(), f"torn checkpoint {p.name}"
    latest = max(int(p.name.split("_")[1]) for p in survivors)
    assert latest >= 4

    out = subprocess.run(_train_cmd(ckpt, latest + 3, resume=True), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert f"[train/resume] resumed from step {latest}" in out.stdout
    # a checkpoint at step N holds N steps' state: the resumed run goes on at step N
    ran = [int(ln.split()[1]) for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert ran == [latest, latest + 1, latest + 2], out.stdout
    assert "done:" in out.stdout


def test_launch_train_needs_a_shape_unless_reduced(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "granite-3-2b", "--device", "cpu"])
    assert "--seq and --batch are required unless --reduced" in capsys.readouterr().err


def test_launch_train_runs_on_cpu(tmp_path, capsys):
    loss = launch_train.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                              "--steps", "3", "--seq", "16", "--batch", "2", "--log-every", "1",
                              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done: 3 steps" in out
    assert np.isfinite(loss)


def test_train_step_keeps_bf16_leaves():
    """An optimizer step never turns a bf16 leaf into f32 (the reduced
    tests run f32 and could not see it)."""
    cfg = dataclasses.replace(reduced(get_config("granite-3-2b")), dtype="bfloat16")
    params = init_params(cfg, device="cpu")
    opt_cfg = OptimizerConfig(warmup_steps=1, decay_steps=2)
    opt_state = adamw_init(params, opt_cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, seq=8).items()}
    before = params["layers"][0]["attn"]["wq"]["w"].clone()
    params, opt_state, metrics = make_train_step(cfg, opt_cfg)(params, opt_state, batch)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    assert all(m.dtype == torch.float32 for m in tree_leaves(opt_state["master"]))
    assert not torch.equal(before, params["layers"][0]["attn"]["wq"]["w"])
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_calls_each_kernel_entry_as_counted(remat, monkeypatch):
    """The kernel entries one training step calls (on the card, one launch
    each): per dense layer 2 rmsnorm, 1 SwiGLU and 1 flash attention in the
    forward, the same again in the backward's recompute under remat, and
    the final norm once; the plain-version backward calls none."""
    from repro_torch.kernels import ops

    calls = {"rmsnorm": 0, "swiglu": 0, "flash_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(ops, name, counted)
    cfg = dataclasses.replace(reduced(get_config("granite-3-2b")), remat=remat)
    params = init_params(cfg, device="cpu")
    opt_cfg = OptimizerConfig(warmup_steps=1, decay_steps=2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, seq=8).items()}
    make_train_step(cfg, opt_cfg)(params, adamw_init(params, opt_cfg), batch)
    L, passes = cfg.num_layers, 2 if remat else 1
    assert calls == {"rmsnorm": passes * 2 * L + 1, "swiglu": passes * L,
                     "flash_attention": passes * L}
