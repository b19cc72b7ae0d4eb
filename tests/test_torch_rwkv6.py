"""The port's rwkv6 (ssm) path against the JAX package on reduced rwkv6-7b.

Reduced rwkv6-7b: 2 layers, d 64, 4 heads of 16, f32.  The reference's
``init_params`` tree is turned into numpy and handed to both packages: as
jax arrays to the reference and through ``from_jax_params`` to the port.
The dense ``w`` leaves, the embedding and the head are multiplied by 40,
as in ``tests/test_torch_model.py``, so the greedy tokens vary; ``mu``,
``w0``, ``u`` and the low-rank leaves keep their init, since scaling them
would push the decay to 0 or 1.  Token ids come from numpy with a fixed
seed.  Logits must agree within 1e-4 (relative and absolute, f32).

The server tests also pin three properties of the reference's server that
the port mirrors (ROADMAP queue C): a recurrent prefill starts from the
live decode state; a lane in a later decode micro-batch is advanced again
with the same pending token; and a refilled slot starts from the previous
request's final state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.kernels import ops as jops
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models.layers import group_norm as jgroup_norm
from repro.models.rwkv6 import rwkv6_channel_mix as jchannel_mix
from repro.models.rwkv6 import rwkv6_time_mix as jtime_mix
from repro.runtime import BatchedServer as JBatchedServer
from repro.runtime import ServerConfig as JServerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import KERNELS
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, from_jax_params, init_decode_state,
                                init_params)
from repro_torch.models.layers import group_norm
from repro_torch.models.rwkv6 import rwkv6_channel_mix, rwkv6_time_mix
from repro_torch.runtime import BatchedServer, ServerConfig

TOL = dict(rtol=1e-4, atol=1e-4)
WEIGHT_MUL = 40.0
SCALED = ("w", "embed")  # the dense w leaves (lm_head's included) and the embedding
SCFG = dict(batch_size=2, max_seq=32, max_new_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_tree(jcfg):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (WEIGHT_MUL if path[-1].key in SCALED else 1.0),
        jinit_params(jax.random.key(0), jcfg))


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) with the same weights."""
    jcfg = jreduced(jget_config("rwkv6-7b"))
    cfg = reduced(get_config("rwkv6-7b"))
    tree = _np_tree(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, device="cpu")


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


# --------------------------------------------------------------------------
# (c) group_norm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 5, 64), 4), ((3, 64), 16), ((1, 7, 32), 2)])
def test_group_norm_matches_reference(shape, groups, dtype):
    """The population variance, as ``jnp.var``: with 4 to 16 values per
    group, ``torch.var``'s default n - 1 would miss by 7% to 33%."""
    x = (np.random.default_rng(0).normal(size=shape) * 3 + 1).astype(np.float32)
    want = jgroup_norm(jnp.asarray(x, getattr(jnp, dtype)), groups, eps=64e-5)
    got = group_norm(torch.from_numpy(x).to(getattr(torch, dtype)), groups, eps=64e-5)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# --------------------------------------------------------------------------
# (d) time-mix and channel-mix
# --------------------------------------------------------------------------
def _layer(jp, tp, i, block):
    return jax.tree.map(lambda a: a[i], jp["layers"][block]), tp["layers"][i][block]


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(models, with_state):
    jcfg, jp, cfg, tp = models
    jl, tl = _layer(jp, tp, 1, "tmix")
    rng = np.random.default_rng(3)
    B, S, d, H, hd = 2, 11, cfg.d_model, cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    last = rng.normal(size=(B, d)).astype(np.float32) if with_state else None
    s0 = (rng.normal(size=(B, H, hd, hd)) * 2).astype(np.float32) if with_state else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want = jtime_mix(jl, jcfg, jnp.asarray(x), last_x=j(last), wkv_state=j(s0))
    s0_copy = None if s0 is None else s0.copy()
    got = rwkv6_time_mix(tl, cfg, torch.from_numpy(x), last_x=t(last), wkv_state=t(s0))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    if with_state:  # the state handed in is read, not written
        assert np.array_equal(s0, s0_copy)


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(models, with_state):
    jcfg, jp, cfg, tp = models
    jl, tl = _layer(jp, tp, 0, "cmix")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    last = rng.normal(size=(2, cfg.d_model)).astype(np.float32) if with_state else None
    want = jchannel_mix(jl, jcfg, jnp.asarray(x),
                        last_x=None if last is None else jnp.asarray(last))
    got = rwkv6_channel_mix(tl, cfg, torch.from_numpy(x),
                            last_x=None if last is None else torch.from_numpy(last))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


# --------------------------------------------------------------------------
# (e) forward, prefill and decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_forward_logits_match_reference(models, backend):
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    with jops.backend_scope(backend):  # pallas: the WKV6 kernel in interpret mode
        want, _, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, cache = forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert cache is None
    assert got.shape == want.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the scaled weights make the greedy tokens vary across positions
    assert len(np.unique(np.asarray(want).argmax(-1))) > 3


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_prefill_and_decode_match_reference(models, backend):
    jcfg, jp, cfg, tp = models
    B, S, T, steps = 2, 9, 24, 6
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    def check_state(state, jstate):
        for key in ("tmix_x", "cmix_x", "wkv"):
            got, want = state["rwkv"][key], np.asarray(jstate["rwkv"][key])
            assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype)
            # a wkv entry sums k.v products over the sequence, and its f32
            # rounding follows the summands, not the sum: near-cancelled
            # entries are held to 1e-6 of the largest entry
            atol = 1e-6 * float(np.abs(want).max()) if key == "wkv" else TOL["atol"]
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"], atol=atol)

    with jops.backend_scope(backend):
        jstate = jinit_decode_state(jcfg, B, T)
        want, jstate, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache=jstate,
                                   cache_pos=jnp.zeros((), jnp.int32))
        state = init_decode_state(cfg, B, T, device="cpu")
        got, state = forward(cfg, tp, {"tokens": torch.from_numpy(toks)}, cache=state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        check_state(state, jstate)

        nxt = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
        jdecode = jax.jit(lambda p, s, t, pos: jdecode_step(jcfg, p, s, t, pos))
        for i in range(steps):
            want, jstate = jdecode(jp, jstate, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
            got, state = decode_step(cfg, tp, state, torch.from_numpy(nxt), S + i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            nxt = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    check_state(state, jstate)


def test_forward_counts_no_launch_on_the_cpu(models):
    _, _, cfg, tp = models
    before = {n: k.launches for n, k in KERNELS.items()}
    forward(cfg, tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert {n: k.launches for n, k in KERNELS.items()} == before


# --------------------------------------------------------------------------
# (f) weights: dtypes through from_jax_params, and the port's own init
# --------------------------------------------------------------------------
def _flat(tree):
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_from_jax_params_keeps_each_leaf_dtype_at_bf16():
    """At bf16 the reference keeps ``tmix.w0`` and ``tmix.u`` in f32; the
    converted tree has every leaf in the reference's dtype, value for
    value."""
    jcfg = dataclasses.replace(jreduced(jget_config("rwkv6-7b")), dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b")), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jinit_params(jax.random.key(0), jcfg))
    got = from_jax_params(tree, cfg, device="cpu")
    want = dict(_flat({k: v for k, v in tree.items() if k != "layers"}))
    for i in range(cfg.num_layers):
        want.update({f"['layers'][{i}]{k}": a[i] for k, a in _flat(tree["layers"]).items()})
    flat = _flat(got)
    assert set(flat) == set(want)
    dtypes = {k: str(a.dtype).split(".")[-1] for k, a in flat.items()}
    assert dtypes == {k: a.dtype.name for k, a in want.items()}
    for i in range(cfg.num_layers):
        assert dtypes[f"['layers'][{i}]['tmix']['w0']"] == "float32"
        assert dtypes[f"['layers'][{i}]['tmix']['u']"] == "float32"
        assert dtypes[f"['layers'][{i}]['tmix']['wr']['w']"] == "bfloat16"
    for k, a in flat.items():
        assert np.array_equal(a.float().numpy(), want[k].astype(np.float32)), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_structure(dtype):
    """The port's own init has the reference's tree: names, shapes, dtypes
    (w0 and u f32 at bf16) and its scales; mu_r equals mu_k as in the
    reference."""
    jcfg = dataclasses.replace(jreduced(jget_config("rwkv6-7b")), dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b")), dtype=dtype)
    want = jax.eval_shape(lambda: jinit_params(jax.random.key(0), jcfg))
    got = init_params(cfg, seed=0, device="cpu")
    assert set(got) == set(want) and len(got["layers"]) == cfg.num_layers
    flat_want = _flat(want["layers"])
    for layer in got["layers"]:
        flat_got = _flat(layer)
        assert set(flat_got) == set(flat_want)
        for k, a in flat_got.items():
            assert tuple(a.shape) == flat_want[k].shape[1:], k
            assert str(a.dtype).split(".")[-1] == str(flat_want[k].dtype), k
    tmix, cmix = got["layers"][0]["tmix"], got["layers"][0]["cmix"]
    assert abs(float(tmix["w0"].mean()) + 6.0) < 0.05
    assert 0.25 <= float(tmix["mu"].float().min()) and float(tmix["mu"].float().max()) <= 0.75
    assert torch.equal(cmix["mu_r"], cmix["mu_k"])
    state = init_decode_state(cfg, 3, 8, device="cpu")
    jstate = jax.eval_shape(lambda: jinit_decode_state(jcfg, 3, 8))
    assert {k: (tuple(a.shape), str(a.dtype).split(".")[-1]) for k, a in state["rwkv"].items()} \
        == {k: (a.shape, str(a.dtype)) for k, a in jstate["rwkv"].items()}


# --------------------------------------------------------------------------
# (g) the server
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def servers():
    """{batch size: (reference server, port server)} over the same weights."""
    jcfg = jreduced(jget_config("rwkv6-7b"))
    cfg = reduced(get_config("rwkv6-7b"))
    tree = _np_tree(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), from_jax_params(tree, cfg, device="cpu")
    out = {}
    for bs in (1, 2):
        scfg = dict(SCFG, batch_size=bs)
        out[bs] = (JBatchedServer(jcfg, jp, JServerConfig(**scfg)),
                   BatchedServer(cfg, tp, ServerConfig(**scfg), device="cpu"))
    return out


def _serve(server, prompts):
    server.reset()
    for p in prompts:
        server.submit(p)
    return dict(server.run_until_drained())  # results is cleared by the next reset()


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n) for n in (5, 9, 7, 12)]


def test_token_streams_match_reference_with_refills(servers):
    """Mixed prompt lengths and more requests than slots: several decode
    micro-batches per step, and slots refilled from the queue."""
    jsrv, srv = servers[2]
    prompts = _prompts()
    got, want = _serve(srv, prompts), _serve(jsrv, prompts)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3]
    assert all(len(v) == SCFG["max_new_tokens"] for v in got.values())


def test_later_micro_batch_lane_is_advanced_again(servers):
    """Reference defect, mirrored: beside a 5-token prompt, the 9-token
    prompt's lane is advanced by the other micro-batch's decode too, so
    it decodes differently from the same prompt served alone."""
    jsrv, srv = servers[2]
    p5, p9 = _prompts()[:2]
    alone, alone_ref = _serve(srv, [p9]), _serve(jsrv, [p9])
    beside, beside_ref = _serve(srv, [p5, p9]), _serve(jsrv, [p5, p9])
    assert alone == alone_ref and beside == beside_ref
    assert beside[1][0] == alone[0][0]  # the prefill's token: before any decode
    assert beside[1] != alone[0]


def test_refilled_slot_starts_from_previous_state(servers):
    """Reference behaviour, mirrored: the prefill starts from the live
    state, so with one slot the second request starts from the first's
    final state and decodes differently from the same prompt served
    alone.  A prefill from fresh zeros would give the alone stream."""
    jsrv, srv = servers[1]
    p5, p9 = _prompts()[:2]
    alone, alone_ref = _serve(srv, [p9]), _serve(jsrv, [p9])
    after, after_ref = _serve(srv, [p5, p9]), _serve(jsrv, [p5, p9])
    assert alone == alone_ref and after == after_ref
    assert after[1] != alone[0]


def test_prefill_keeps_other_lanes(servers):
    """The padded prefill runs on a copy of the live state: only the
    slot's lane of every leaf changes."""
    _, srv = servers[2]
    srv.reset()
    gen = torch.Generator().manual_seed(0)
    for a in srv.state["rwkv"].values():
        a.copy_(torch.randn(a.shape, generator=gen))
    before = {k: a.clone() for k, a in srv.state["rwkv"].items()}
    srv.submit(_prompts()[1])
    srv._refill()  # prefill into slot 0, no decode
    for k, a in srv.state["rwkv"].items():
        assert torch.equal(a[:, 1], before[k][:, 1]), k
        assert not torch.equal(a[:, 0], before[k][:, 0]), k
    srv.reset()
    assert all(float(a.abs().sum()) == 0.0 for a in srv.state["rwkv"].values())


# --------------------------------------------------------------------------
# (h) the serve CLI
# --------------------------------------------------------------------------
def test_launch_serve_rwkv6_runs_on_cpu(capsys):
    rep = serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                      "--requests", "3", "--new-tokens", "4"])
    assert rep["requests"] == 3 and rep["tokens"] == 12
    out = capsys.readouterr().out
    assert "[serve/kernels]" in out and "wkv6=0" in out
