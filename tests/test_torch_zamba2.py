"""The port's zamba2 (hybrid) path against the JAX package on reduced zamba2-2.7b.

Reduced zamba2-2.7b: 4 Mamba2 layers with the shared attention block after
layers 1 and 3 (``hybrid_attn_every`` 2), d 64, Mamba2 heads of P 16 with
state N 8 (so H 8), f32.  The reference's ``init_params`` tree is turned
into numpy and handed to both packages: as jax arrays to the reference and
through ``from_jax_params`` to the port.  The embedding, the head and
every projection that writes into the residual stream (each Mamba2
``out_proj``, the shared block's ``wo`` and ``down``) are multiplied by 40,
as ``tests/test_torch_model.py`` multiplies every dense weight, so the
blocks move the residual stream and the greedy tokens vary.  The input
projections keep their init: ``in_proj`` times 40 would push dt to about 6
and the decay to about 0, so the recurrence would carry almost nothing
from one step to the next, and in that regime the reference's own f32
logits miss a float64 run by 7e-4.  The other projections (the
attention's q, k and v, the FFN's gate and up) keep their init too, so
every nonlinearity sees activations of the size its init gives.  Token ids and activations come
from numpy with a fixed seed.  Logits must agree within 1e-4 (relative
and absolute, f32).

The server tests also pin the reference server's three defects that the
port mirrors (ROADMAP queue C), all of which a hybrid inherits: a
recurrent prefill starts from the live decode state; a lane in a later
decode micro-batch is advanced again with the same pending token (and gets
that micro-batch's K/V written into its history); and a refilled slot
starts from the previous request's final state.
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
from repro.models.mamba2 import _causal_conv as jcausal_conv
from repro.models.mamba2 import mamba2_block as jmamba2_block
from repro.runtime import BatchedServer as JBatchedServer
from repro.runtime import ServerConfig as JServerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import KERNELS
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, from_jax_params, init_decode_state,
                                init_params)
from repro_torch.models.mamba2 import _causal_conv, mamba2_block
from repro_torch.runtime import BatchedServer, ServerConfig

ARCH = "zamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
WEIGHT_MUL = 40.0
#: the projections into the residual stream, scaled with the embedding and the head
SCALED_PROJECTIONS = ("out_proj", "wo", "down", "lm_head")
SCFG = dict(batch_size=2, max_seq=32, max_new_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jreduced(jget_config(ARCH)), dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype))


def _scaled(path) -> bool:
    keys = [getattr(k, "key", None) for k in path]
    return keys[-1] == "embed" or (keys[-1] == "w" and keys[-2] in SCALED_PROJECTIONS)


def _np_tree(jcfg):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (WEIGHT_MUL if _scaled(path) else 1.0),
        jinit_params(jax.random.key(0), jcfg))


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) with the same weights."""
    jcfg, cfg = _cfgs()
    tree = _np_tree(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, device="cpu")


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype`` (both
    round the f32 values to bf16 the same way, to nearest even)."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def test_reduced_config_matches_reference():
    jcfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.family, cfg.num_layers, cfg.hybrid_attn_every) == ("hybrid", 4, 2)
    assert (cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.expand * cfg.d_model) == (16, 8, 128)


# --------------------------------------------------------------------------
# the Mamba2 block: causal conv, and the whole block with and without state
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, dtype):
    rng = np.random.default_rng(5)
    B, S, K, ch = 2, 7, 4, 24
    jx, tx = _pair(rng.normal(size=(B, S, ch)).astype(np.float32), dtype)
    jw, tw = _pair((rng.normal(size=(K, ch)) * 0.1).astype(np.float32), dtype)
    jb, tb = _pair((rng.normal(size=(ch,)) * 0.1).astype(np.float32), dtype)
    js, ts = (_pair(rng.normal(size=(B, K - 1, ch)).astype(np.float32), dtype) if with_state
              else (None, None))
    want_out, want_state = jcausal_conv(jx, jw, jb, js)
    got_out, got_state = _causal_conv(tx, tw, tb, ts)
    tol = TOL if dtype == "float32" else BF16_TOL
    for g, w in ((got_out, want_out), (got_state, want_state)):
        assert tuple(g.shape) == w.shape and g.dtype == tx.dtype
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    # the new conv state is the last K-1 inputs, exactly
    assert torch.equal(got_state, tx[:, -(K - 1):])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches_reference(with_state, dtype):
    jcfg, cfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, jinit_params(jax.random.key(0), jcfg))
    jl = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["layers"]["mamba"])
    tl = from_jax_params(tree, cfg, device="cpu")["layers"][1]["mamba"]
    rng = np.random.default_rng(3)
    B, S, d = 2, 11, cfg.d_model
    H, P, N = 8, cfg.ssm.head_dim, cfg.ssm.state_dim
    jx, tx = _pair(rng.normal(size=(B, S, d)).astype(np.float32), dtype)
    jst = tst = None
    if with_state:
        conv = rng.normal(size=(B, cfg.ssm.conv_dim - 1, 2 * d + 2 * N)).astype(np.float32)
        ssm = (rng.normal(size=(B, H, P, N)) * 2).astype(np.float32)
        jc, tc = _pair(conv, dtype)
        jst = {"conv": jc, "ssm": jnp.asarray(ssm)}
        tst = {"conv": tc, "ssm": torch.from_numpy(ssm)}
        before = {k: v.clone() for k, v in tst.items()}
    want, want_st = jmamba2_block(jl, jcfg, jx, state=jst)
    got, got_st = mamba2_block(tl, cfg, tx, state=tst)
    tol = TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    if not with_state:
        assert got_st is None and want_st is None
        return
    assert got_st["ssm"].dtype == torch.float32 and got_st["conv"].dtype == tx.dtype
    np.testing.assert_allclose(_np(got_st["conv"]), _np(want_st["conv"]), **tol)
    np.testing.assert_allclose(_np(got_st["ssm"]), _np(want_st["ssm"]), **TOL)
    for k, v in tst.items():  # the state handed in is read, not written
        assert torch.equal(v, before[k]), k


# --------------------------------------------------------------------------
# forward, prefill and decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_forward_logits_match_reference(models, backend):
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    with jops.backend_scope(backend):  # pallas: rmsnorm, swiglu, flash in interpret mode
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
        pairs = [(state["mamba"][k], jstate["mamba"][k]) for k in ("conv", "ssm")]
        pairs += [(state[k], jstate[k]) for k in ("shared_k", "shared_v")]
        for got, want in pairs:
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype)
            np.testing.assert_allclose(got.numpy(), want, **TOL)

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
    state = init_decode_state(cfg, 1, 8, device="cpu")
    forward(cfg, tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cache=state)
    decode_step(cfg, tp, state, torch.zeros((1, 1), dtype=torch.long), 4)
    assert {n: k.launches for n, k in KERNELS.items()} == before


# --------------------------------------------------------------------------
# weights: dtypes through from_jax_params, and the port's own init
# --------------------------------------------------------------------------
def _flat(tree):
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


F32_LEAVES = ("a_log", "d_skip", "dt_bias")


def test_from_jax_params_keeps_each_leaf_dtype_at_bf16():
    """At bf16 the reference keeps each Mamba2 layer's ``a_log``,
    ``d_skip`` and ``dt_bias`` in f32; the converted tree has every leaf,
    the shared block's included, in the reference's dtype, value for
    value."""
    jcfg, cfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jinit_params(jax.random.key(0), jcfg))
    got = from_jax_params(tree, cfg, device="cpu")
    assert set(got["shared_block"]) == {"ln1", "attn", "ln2", "ffn"}
    want = dict(_flat({k: v for k, v in tree.items() if k != "layers"}))
    for i in range(cfg.num_layers):
        want.update({f"['layers'][{i}]{k}": a[i] for k, a in _flat(tree["layers"]).items()})
    flat = _flat(got)
    assert set(flat) == set(want)
    dtypes = {k: str(a.dtype).split(".")[-1] for k, a in flat.items()}
    assert dtypes == {k: a.dtype.name for k, a in want.items()}
    for i in range(cfg.num_layers):
        for leaf in F32_LEAVES:
            assert dtypes[f"['layers'][{i}]['mamba']['{leaf}']"] == "float32"
        assert dtypes[f"['layers'][{i}]['mamba']['in_proj']['w']"] == "bfloat16"
    assert dtypes["['shared_block']['attn']['wq']['w']"] == "bfloat16"
    for k, a in flat.items():
        assert np.array_equal(a.float().numpy(), want[k].astype(np.float32)), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference_structure(dtype):
    """The port's own init has the reference's tree: names, shapes, dtypes
    (a_log, d_skip and dt_bias f32 at bf16), the shared block, and the
    reference's constants and scales; the decode state has the reference's
    leaves."""
    jcfg, cfg = _cfgs(dtype)
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
    shared_got, shared_want = _flat(got["shared_block"]), _flat(want["shared_block"])
    assert {k: (tuple(a.shape), str(a.dtype).split(".")[-1]) for k, a in shared_got.items()} \
        == {k: (a.shape, str(a.dtype)) for k, a in shared_want.items()}
    m = got["layers"][0]["mamba"]
    assert float(m["a_log"].abs().max()) == 0.0 and float(m["dt_bias"].abs().max()) == 0.0
    assert float((m["d_skip"] - 1).abs().max()) == 0.0 and float(m["conv_b"].abs().max()) == 0.0
    assert 0.05 < float(m["conv_w"].float().std()) < 0.2
    state = init_decode_state(cfg, 3, 8, device="cpu")
    jstate = jax.eval_shape(lambda: jinit_decode_state(jcfg, 3, 8))
    assert _flat({k: v for k, v in state.items()}).keys() == _flat(jstate).keys()
    for k, a in _flat(state).items():
        assert (tuple(a.shape), str(a.dtype).split(".")[-1]) == \
            (_flat(jstate)[k].shape, str(_flat(jstate)[k].dtype)), k


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def servers(models):
    """{batch size: (reference server, port server)} over the same weights."""
    jcfg, jp, cfg, tp = models
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
    prompt's lane is advanced by the other micro-batch's decode too (its
    Mamba2 state, and the K/V written at the other position), so it
    decodes differently from the same prompt served alone."""
    jsrv, srv = servers[2]
    p5, p9 = _prompts()[:2]
    alone, alone_ref = _serve(srv, [p9]), _serve(jsrv, [p9])
    beside, beside_ref = _serve(srv, [p5, p9]), _serve(jsrv, [p5, p9])
    assert alone == alone_ref and beside == beside_ref
    assert beside[1][0] == alone[0][0]  # the prefill's token: before any decode
    assert beside[1] != alone[0]


def test_refilled_slot_starts_from_previous_state(servers):
    """Reference behaviour, mirrored: the prefill starts from the live
    Mamba2 state, so with one slot the second request starts from the
    first's final state and decodes differently from the same prompt
    served alone.  A prefill from fresh zeros would give the alone
    stream."""
    jsrv, srv = servers[1]
    p5, p9 = _prompts()[:2]
    alone, alone_ref = _serve(srv, [p9]), _serve(jsrv, [p9])
    after, after_ref = _serve(srv, [p5, p9]), _serve(jsrv, [p5, p9])
    assert alone == alone_ref and after == after_ref
    assert after[1] != alone[0]


def test_prefill_keeps_other_lanes(servers):
    """The padded prefill runs on a copy of the live Mamba2 state and on
    S-long K/V scratch: only the slot's lane changes, and of its shared
    K/V only positions [0, S)."""
    _, srv = servers[2]
    srv.reset()
    gen = torch.Generator().manual_seed(0)
    live = [srv.state["mamba"]["conv"], srv.state["mamba"]["ssm"], srv.state["shared_k"],
            srv.state["shared_v"]]
    for a in live:
        a.copy_(torch.randn(a.shape, generator=gen))
    before = [a.clone() for a in live]
    prompt = _prompts()[1]
    S = len(prompt)
    srv.submit(prompt)
    srv._refill()  # prefill into slot 0, no decode
    for a, b in zip(live, before):
        assert torch.equal(a[:, 1], b[:, 1])
        assert not torch.equal(a[:, 0], b[:, 0])
    for a, b in zip(live[2:], before[2:]):  # shared K/V: (slots, B, Hkv, T, hd)
        assert torch.equal(a[:, 0, :, S:], b[:, 0, :, S:])
        assert not torch.equal(a[:, 0, :, :S], b[:, 0, :, :S])
    srv.reset()
    assert all(float(a.abs().sum()) == 0.0 for a in
               [srv.state["shared_k"], srv.state["shared_v"], *srv.state["mamba"].values()])


# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------
def test_launch_serve_zamba2_runs_on_cpu(capsys):
    rep = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "3", "--new-tokens", "4"])
    assert rep["requests"] == 3 and rep["tokens"] == 12
    out = capsys.readouterr().out
    assert "[serve/kernels]" in out and "mamba2_ssd=0" in out
