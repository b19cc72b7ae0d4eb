"""The port's vision (phi-3-vision-4.2b) and audio (hubert-xlarge) families
against the JAX package on the CPU.

The reference's ``init_params`` tree is turned into numpy and handed to
both packages, its weights multiplied by ``WEIGHT_MUL`` so that the greedy
tokens vary and the gradients are large enough to hold at 1e-5; token ids,
image and frame embeddings come from numpy with a fixed seed.

* Forward logits within 1e-4 of the reference's under its ``ref`` and
  ``pallas`` (interpret mode) backends: reduced phi-3-vision with
  ``image_embeds`` at the reduced head dim 16 and at phi-3-vision's own
  96, and reduced hubert (non-causal).  The reference's Pallas kernel
  refuses non-causal attention when ``T % min(128, T)`` is not 0
  (``src/repro/kernels/flash_attention.py:107-108``): hubert at a ragged
  frame count (200, 300) is held to the ``ref`` backend only, and a test
  shows the refusal.
* ``loss_fn`` and every gradient within 1e-5 for both families.
* phi-3-vision's prefill (with the image prefix) plus decode: logits and
  greedy tokens equal to the reference's.
* ``BatchedServer`` streams equal to the reference's for reduced
  phi-3-vision, served on tokens alone; the encoder-only hubert is refused
  by the server and by both launchers.
* ``input_specs`` and ``shape_supported`` equal to the reference's for
  every arch and every shape; an image prefix longer than the sequence
  raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config, input_specs as jinput_specs
from repro.configs import reduced as jreduced, shape_supported as jshape_supported
from repro.kernels import ops as jops
from repro.models import decode_step as jdecode_step, forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params, loss_fn as jloss_fn
from repro.runtime import BatchedServer as JBatchedServer, ServerConfig as JServerConfig
from repro_torch.configs import SHAPES, get_config, input_specs, list_archs, reduced
from repro_torch.configs import shape_supported
from repro_torch.launch import serve, train
from repro_torch.models import (decode_step, forward, from_jax_params, init_decode_state,
                                init_params, loss_fn)
from repro_torch.runtime import BatchedServer, ServerConfig
from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map

VLM, AUDIO = "phi-3-vision-4.2b", "hubert-xlarge"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_train.py's
#: 10, not tests/test_torch_model.py's 40: these inputs are N(0, 1) image
#: and frame embeddings, 50x the token table's 0.02, and at 40 the f32
#: forwards of both packages sit up to 1.4e-3 from a float64 forward of the
#: same weights (logits up to 27), each as far as the other.  At 10 both are
#: within 9e-6 of it, and the argmax still takes 19 to 94 values.
WEIGHT_MUL = 10.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(arch, mul=WEIGHT_MUL, **changes):
    """(jax cfg, jax params, port cfg, port params) with the same weights,
    every one but the norms' scales multiplied by ``mul``."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (1.0 if path[-1].key == "scale" else mul),
        jinit_params(jax.random.key(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def vlm():
    return _models(VLM)


@pytest.fixture(scope="module")
def audio():
    return _models(AUDIO)


def _batch(cfg, B=2, S=12, seed=1, labels=False):
    """numpy inputs under the reference's keys: tokens (and image_embeds
    for vision), or frame embeds for audio; labels when asked."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "audio":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "vision":
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _check_forward(models, backend, batch):
    jcfg, jp, cfg, tp = models
    jb, tb = _both(batch)
    with jops.backend_scope(backend):  # pallas: interpret mode on the CPU
        want, _, _ = jforward(jcfg, jp, jb)
    got, _ = forward(cfg, tp, tb)
    assert got.shape == want.shape == batch[next(iter(batch))].shape[:2] + (cfg.vocab_size,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(np.unique(np.asarray(want).argmax(-1))) > 3
    return got


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_vlm_forward_with_image_prefix_matches_reference(vlm, backend):
    cfg = vlm[2]
    batch = _batch(cfg)
    got = _check_forward(vlm, backend, batch)
    # the prefix is used: the same tokens without it give other logits
    text, _ = forward(cfg, vlm[3], {"tokens": torch.from_numpy(batch["tokens"])})
    assert not torch.allclose(got, text, **TOL)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_vlm_forward_at_head_dim_96_matches_reference(backend):
    """phi-3-vision's own head dim, the one the card's kernel gained."""
    models = _models(VLM, head_dim=96)
    assert models[2].head_dim == 96
    _check_forward(models, backend, _batch(models[2], S=10, seed=5))


@pytest.mark.parametrize("backend,S", [("ref", 12), ("pallas", 12), ("pallas", 128),
                                       ("ref", 200), ("ref", 300)])
def test_audio_forward_matches_reference(audio, backend, S):
    """Non-causal attention over frame embeddings.  S 200 and 300 are
    ragged against the reference's 128-key Pallas block, which it refuses
    for non-causal attention (next test), so they run under ``ref``."""
    assert not audio[2].causal and "embed" not in audio[3]
    _check_forward(audio, backend, _batch(audio[2], B=1 if S > 100 else 2, S=S, seed=S))


def test_reference_pallas_refuses_ragged_non_causal(audio):
    jcfg, jp, cfg, _ = audio
    jb, _ = _both(_batch(cfg, B=1, S=200))
    with jops.backend_scope("pallas"), pytest.raises(ValueError, match="T % block_k"):
        jforward(jcfg, jp, jb)


def _ref_layout(tree):
    """The port's tree as numpy leaves keyed like the reference's."""
    tree = tree_map(lambda a: a.detach().float().numpy(), tree)
    layers = tree.pop("layers")
    tree["layers"] = tree_map(lambda *xs: np.stack(xs), layers[0], *layers[1:])
    return tree_flatten_with_keys(tree)


@pytest.mark.parametrize("arch,changes", [
    pytest.param(VLM, dict(head_dim=96), id="vlm-hd96"),
    pytest.param(AUDIO, dict(loss_chunk=8), id="audio-chunked"),
    pytest.param(AUDIO, dict(remat=True), id="audio-remat"),
])
def test_loss_and_gradients_match_reference(arch, changes):
    jcfg, jp, cfg, tp = _models(arch, **changes)
    batch = _batch(cfg, S=16, seed=7, labels=True)
    jb, tb = _both(batch)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(jcfg, p, jb),
                                             has_aux=True))(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(cfg, tp, tb)
    grads = iter(torch.autograd.grad(loss, leaves))
    got = _ref_layout(tree_map(lambda _: next(grads), tp))
    want = {"/".join(str(k.key) for k in path): np.asarray(a, dtype=np.float32)
            for path, a in jax.tree_util.tree_flatten_with_path(jg)[0]}
    np.testing.assert_allclose(float(loss.detach()), float(jl), **GRAD_TOL)
    assert float(metrics["ce"].detach()) == float(loss.detach())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_vlm_prefill_with_image_and_decode_match_reference(vlm):
    jcfg, jp, cfg, tp = vlm
    B, S, T, steps = 2, 9, 24, 5
    jb, tb = _both(_batch(cfg, B=B, S=S, seed=2))
    jstate = jinit_decode_state(jcfg, B, T)
    want, jstate, _ = jforward(jcfg, jp, jb, cache=jstate, cache_pos=jnp.zeros((), jnp.int32))
    state = init_decode_state(cfg, B, T, device="cpu")
    got, state = forward(cfg, tp, tb, cache=state, cache_pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(state["k"].numpy(), np.asarray(jstate["k"]), **TOL)
    nxt = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
    jdecode = jax.jit(lambda p, s, t, pos: jdecode_step(jcfg, p, s, t, pos))
    tokens = []
    for i in range(steps):
        want, jstate = jdecode(jp, jstate, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        got, state = decode_step(cfg, tp, state, torch.from_numpy(nxt), S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert np.array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
        nxt = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
        tokens.append(nxt[:, 0])
    assert len(np.unique(tokens)) > 1


def test_vlm_server_streams_match_reference(vlm):
    """Served on tokens alone, as the reference's server serves it."""
    jcfg, jp, cfg, tp = vlm
    scfg = dict(batch_size=2, max_seq=32, max_new_tokens=6)
    jsrv = JBatchedServer(jcfg, jp, JServerConfig(**scfg))
    srv = BatchedServer(cfg, tp, ServerConfig(**scfg), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 7)]
    for s in (jsrv, srv):
        for p in prompts:
            s.submit(p)
    want, got = jsrv.run_until_drained(), srv.run_until_drained()
    assert got == want and sorted(got) == [0, 1, 2]
    assert all(len(v) == scfg["max_new_tokens"] for v in got.values())


def test_encoder_only_is_refused_by_server_and_launchers(audio, capsys):
    cfg, tp = audio[2], audio[3]
    with pytest.raises(ValueError, match="encoder-only"):
        BatchedServer(cfg, tp, ServerConfig(), device="cpu")
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO, "--reduced", "--device", "cpu"])
    with pytest.raises(SystemExit, match="frame embeddings"):
        train.main(["--arch", AUDIO, "--reduced", "--device", "cpu", "--steps", "1"])


def test_launchers_run_vlm_text_only_on_cpu(tmp_path, capsys):
    rep = serve.main(["--arch", VLM, "--reduced", "--device", "cpu", "--requests", "2",
                      "--new-tokens", "3"])
    assert rep["requests"] == 2 and rep["tokens"] == 6
    loss = train.main(["--arch", VLM, "--reduced", "--device", "cpu", "--steps", "2",
                       "--ckpt-dir", str(tmp_path / "ckpt")])
    assert np.isfinite(loss)
    assert "[serve/kernels]" in capsys.readouterr().out


def test_audio_params_have_no_table_and_match_reference_tree():
    """An audio model's own init has the reference's tree: no ``embed``,
    a separate head, GELU FFNs."""
    for arch in (AUDIO, VLM):
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        want = jax.eval_shape(lambda: jinit_params(jax.random.key(0), jcfg))
        got = init_params(cfg, seed=0, device="cpu")
        assert set(got) == set(want)
        assert ("embed" in got) == (arch == VLM)
        flat_want = {jax.tree_util.keystr(p): a.shape[1:] for p, a in
                     jax.tree_util.tree_flatten_with_path(want["layers"])[0]}
        flat_got = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
                    jax.tree_util.tree_flatten_with_path(got["layers"][0])[0]}
        assert flat_got == flat_want


def test_input_specs_and_shape_supported_match_reference():
    assert set(SHAPES) == set(JSHAPES)
    for name in SHAPES:
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(JSHAPES[name])
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name in SHAPES:
            assert shape_supported(cfg, SHAPES[name]) == jshape_supported(jcfg, JSHAPES[name])
            got = {k: (s.shape, str(s.dtype).split(".")[-1])
                   for k, s in input_specs(cfg, SHAPES[name]).items()}
            want = {k: (tuple(s.shape), str(s.dtype))
                    for k, s in jinput_specs(jcfg, JSHAPES[name]).items()}
            assert got == want, (arch, name)


def test_image_prefix_longer_than_the_sequence_raises(vlm):
    jcfg, jp, cfg, tp = vlm
    batch = _batch(cfg, S=cfg.num_prefix_embeds - 1)
    jb, tb = _both(batch)
    with pytest.raises(ValueError, match="do not fit"):
        forward(cfg, tp, tb)
    with pytest.raises(TypeError):  # dynamic_update_slice refuses it too
        jforward(jcfg, jp, jb)
    # a prefix that fills the sequence is the image alone
    batch = _batch(cfg, S=cfg.num_prefix_embeds)
    _, tb = _both(batch)
    got, _ = forward(cfg, tp, tb, head_mode="none")
    alone, _ = forward(cfg, tp, dict(tb, tokens=torch.zeros_like(tb["tokens"])),
                       head_mode="none")
    torch.testing.assert_close(got, alone)
