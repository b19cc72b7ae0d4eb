"""The port's dense decoder against the JAX package on reduced granite-3-2b.

The reference's ``init_params`` tree is turned into numpy, its random
weights multiplied by 40 (at the 0.02 init every prompt decodes to the same
greedy token, which would prove nothing), and handed to both packages: as
jax arrays to the reference and through ``from_jax_params`` to the port.
Token ids come from numpy with a fixed seed.  Logits must agree within
1e-4 (relative and absolute, f32).

The other dense configs are held the same way, forward and prefill plus
4 decode steps, on reduced phi4-mini (tied head), qwen3-32b (``qk_norm``)
and qwen2.5-32b (``qkv_bias``, with the biases set to non-zero values);
and ``forward``'s ``head_mode`` "last" and "none" against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, list_archs as jlist_archs
from repro.configs import param_count as jparam_count, reduced as jreduced
from repro.kernels import ops as jops
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models.layers import apply_rope as japply_rope
from repro_torch.configs import get_config, list_archs, param_count, reduced
from repro_torch.models import (decode_step, forward, from_jax_params, init_decode_state,
                                init_params)
from repro_torch.models.layers import apply_rope

TOL = dict(rtol=1e-4, atol=1e-4)
WEIGHT_MUL = 40.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(arch):
    """(jax cfg, jax params, port cfg, port params) with the same weights:
    dense weights times WEIGHT_MUL; biases (qwen2.5's QKV), zero at init,
    drawn at the weights' scale, 0.02 times WEIGHT_MUL."""
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(3)

    def scaled(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return a
        if path[-1].key == "b":
            return (rng.normal(size=a.shape) * 0.02 * WEIGHT_MUL).astype(a.dtype)
        return a * WEIGHT_MUL

    tree = jax.tree_util.tree_map_with_path(scaled, jinit_params(jax.random.key(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models("granite-3-2b")


def test_configs_match_reference():
    """The port's copy of the config registry is the reference's, field
    for field, and so are ``reduced`` and ``param_count``."""
    assert list_archs() == jlist_archs()
    for name in list_archs():
        cfg, jcfg = get_config(name), jget_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(jreduced(jcfg)), name
        assert param_count(cfg) == jparam_count(jcfg), name
        assert cfg.padded_vocab == jcfg.padded_vocab, name


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = (3 + np.arange(7))[None, :].repeat(2, 0).astype(np.int32)
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_params_matches_reference_structure():
    """The port's own init has the reference's tree: names, shapes, dtypes
    (layers split from the stacked axis), and its scales."""
    jcfg = jreduced(jget_config("granite-3-2b"))
    cfg = reduced(get_config("granite-3-2b"))
    want = jax.eval_shape(lambda: jinit_params(jax.random.key(0), jcfg))
    got = init_params(cfg, seed=0, device="cpu")
    assert set(got) == set(want) and len(got["layers"]) == cfg.num_layers
    flat_want = {jax.tree_util.keystr(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(want["layers"])[0]}
    for i, layer in enumerate(got["layers"]):
        flat_got = {jax.tree_util.keystr(p): a for p, a in
                    jax.tree_util.tree_flatten_with_path(layer)[0]}
        assert set(flat_got) == set(flat_want)
        for k, a in flat_got.items():
            assert tuple(a.shape) == flat_want[k].shape[1:], k
            assert str(a.dtype).split(".")[-1] == str(flat_want[k].dtype), k
    assert tuple(got["embed"].shape) == want["embed"].shape
    assert abs(float(got["embed"].std()) - 0.02) < 2e-3
    down_scale = 0.02 / (2 * cfg.num_layers) ** 0.5
    assert abs(float(got["layers"][0]["ffn"]["down"]["w"].std()) - down_scale) < 0.1 * down_scale
    again = init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["attn"]["wq"]["w"], got["layers"][1]["attn"]["wq"]["w"])


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_forward_logits_match_reference(models, backend):
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    with jops.backend_scope(backend):  # pallas: interpret mode on the CPU
        want, _, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _ = forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the scaled weights make the greedy tokens vary across positions
    assert len(np.unique(np.asarray(want).argmax(-1))) > 3


def test_prefill_and_decode_match_reference(models):
    _check_prefill_and_decode(*models, steps=6)


def _check_prefill_and_decode(jcfg, jp, cfg, tp, steps):
    B, S, T = 2, 9, 24
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    jstate = jinit_decode_state(jcfg, B, T)
    want, jstate, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache=jstate,
                               cache_pos=jnp.zeros((), jnp.int32))
    state = init_decode_state(cfg, B, T, device="cpu")
    got, state = forward(cfg, tp, {"tokens": torch.from_numpy(toks)}, cache=state,
                         cache_pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(state["k"].numpy(), np.asarray(jstate["k"]), **TOL)

    nxt = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
    jdecode = jax.jit(lambda p, s, t, pos: jdecode_step(jcfg, p, s, t, pos))
    for i in range(steps):
        want, jstate = jdecode(jp, jstate, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        got, state = decode_step(cfg, tp, state, torch.from_numpy(nxt), S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        nxt = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_allclose(state["v"].numpy(), np.asarray(jstate["v"]), **TOL)


OTHER_DENSE = ["phi4-mini-3.8b", "qwen3-32b", "qwen2.5-32b"]


@pytest.mark.parametrize("arch", OTHER_DENSE)
def test_other_dense_forward_matches_reference(arch):
    jcfg, jp, cfg, tp = _models(arch)
    assert (cfg.tie_embeddings, cfg.qk_norm, cfg.qkv_bias) == {
        "phi4-mini-3.8b": (True, False, False), "qwen3-32b": (False, True, False),
        "qwen2.5-32b": (False, False, True)}[arch]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _ = forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(np.unique(np.asarray(want).argmax(-1))) > 3


@pytest.mark.parametrize("arch", OTHER_DENSE)
def test_other_dense_prefill_and_decode_match_reference(arch):
    _check_prefill_and_decode(*_models(arch), steps=4)


@pytest.mark.parametrize("head_mode", ["last", "none"])
def test_head_modes_match_reference(models, head_mode):
    """``"last"``: the (B, vocab) logits of the last position; ``"none"``:
    the final-normed hidden, which the loss heads itself."""
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want, _, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)}, head_mode=head_mode)
    got, _ = forward(cfg, tp, {"tokens": torch.from_numpy(toks)}, head_mode=head_mode)
    shape = (2, cfg.vocab_size) if head_mode == "last" else (2, 10, cfg.d_model)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if head_mode == "last":
        full, _ = forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), **TOL)
