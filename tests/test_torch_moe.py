"""The port's Mixture-of-Experts block and MoE models against the JAX package.

Reduced llama4-scout-17b-a16e (4 experts, top-1, a shared expert) and
reduced arctic-480b (4 experts, top-2, a dense residual FFN), f32.  The
reference's ``init_params`` tree is turned into numpy, every weight but the
norms' scales multiplied (by ``BLOCK_MUL`` for the block, whose outputs are
then of order 1, and by ``WEIGHT_MUL`` for the models, as
``tests/test_torch_model.py`` does, so that greedy tokens vary), and handed
to both packages: as jax arrays to the reference and through
``from_jax_params`` to the port.  Inputs come from numpy with fixed seeds.

* ``moe_block``'s output and both aux losses at fp32 1e-5, on token counts
  that give 1 group, a middle divisor (21) and 32 groups;
* a router that sends most tokens to one expert: the expert overflows its
  capacity, and the kept tokens must be the reference's, the first C of
  each group in token order (a stable sort's);
* ``forward`` logits at 1e-4 (A2's gate), prefill followed by decode;
* ``loss_fn`` and every gradient against ``jax.grad`` at 1e-5, with
  ``load_balance`` and ``router_z`` reported;
* bf16 leaf dtypes (the router stays f32);
* ``BatchedServer`` token streams equal to the reference's server,
  mirroring its cross-slot decode schedule (ROADMAP queue C);
* ``expert_parallel`` and ``active_param_count`` for every config;
* the expert-parallel block in a world of one gloo rank, equal bit for bit
  to the one-device block (the 8-rank world is ``test_torch_moe_exec.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import active_param_count as jactive_param_count
from repro.configs import expert_parallel as jexpert_parallel
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.data import DataConfig as JDataConfig, SyntheticLMPipeline as JPipeline
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params, loss_fn as jloss_fn
from repro.models.mlp import ffn_apply as jffn_apply
from repro.models.moe import moe_block as jmoe_block
from repro.runtime import BatchedServer as JBatchedServer
from repro.runtime import ServerConfig as JServerConfig
from repro_torch.comms import api as tapi
from repro_torch.configs import (active_param_count, expert_parallel, get_config,
                                 list_archs, reduced)
from repro_torch.models import (decode_step, forward, from_jax_params, init_decode_state,
                                init_params, loss_fn)
from repro_torch.models.moe import _num_groups, moe_block
from repro_torch.runtime import BatchedServer, ServerConfig
from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map

ARCHS = ["llama4-scout-17b-a16e", "arctic-480b"]
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
#: block weights: the 0.02 init times 6 is about 1/sqrt(fan-in) at d 64
BLOCK_MUL = 6.0
#: model weights, as tests/test_torch_model.py scales them
WEIGHT_MUL = 40.0
#: loss and gradients, as tests/test_torch_train.py scales them
GRAD_MUL = 10.0
#: (B, S) by the number of groups moe_block splits B * S tokens into
SHAPES = {1: (1, 37), 21: (2, 21), 32: (2, 64)}
SCFG = dict(batch_size=2, max_seq=32, max_new_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(arch, mul, **changes):
    """(jax cfg, numpy tree, port cfg): the reference's init, every weight
    but the norms' scales times ``mul``."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (1.0 if path[-1].key == "scale" else mul),
        jinit_params(jax.random.key(0), jcfg))
    return jcfg, tree, cfg


def _models(arch, mul, **changes):
    jcfg, tree, cfg = _tree(arch, mul, **changes)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_jax_params(tree, cfg, device="cpu")


def _block(arch):
    """(jax cfg, reference layer-0 MoE params, port cfg, port params)."""
    jcfg, tree, cfg = _tree(arch, BLOCK_MUL)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["moe"])
    return jcfg, jp, cfg, from_jax_params(tree, cfg, device="cpu")["layers"][0]["moe"]


def _x(B, S, d, seed=1, offset=0.0):
    return (np.random.default_rng(seed).standard_normal((B, S, d)) + offset).astype(np.float32)


@pytest.mark.parametrize("groups", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, groups):
    jcfg, jp, cfg, tp = _block(arch)
    B, S = SHAPES[groups]
    assert _num_groups(B * S) == groups
    x = _x(B, S, cfg.d_model)
    want, jaux = jmoe_block(jp, jcfg, jnp.asarray(x))
    got, aux = moe_block(tp, cfg, torch.from_numpy(x))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    assert set(aux) == set(jaux) == {"load_balance", "router_z"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=k, **BLOCK_TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.5  # outputs of order 1


def test_overflow_keeps_the_references_tokens():
    """A router column that outweighs the rest sends most tokens to expert
    0, which overflows its capacity; the tokens it keeps are the
    reference's, the first C of each group in token order."""
    arch = "llama4-scout-17b-a16e"
    jcfg, jp, cfg, tp = _block(arch)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 0] += 0.5
    jp = dict(jp, router={"w": jnp.asarray(w)})
    tp = dict(tp, router={"w": torch.from_numpy(w)})
    B, S = SHAPES[21]
    x = _x(B, S, cfg.d_model, seed=5, offset=1.0)  # positive mean: logit 0 leads
    want, _ = jmoe_block(jp, jcfg, jnp.asarray(x))
    got, _ = moe_block(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)

    # a token the experts dropped gets only the shared expert's output
    shared = np.asarray(jffn_apply(jp["shared"], jnp.asarray(x)))
    kept_ref = np.abs(np.asarray(want) - shared).max(-1) > 1e-3
    kept = np.abs(got.numpy() - shared).max(-1) > 1e-3
    np.testing.assert_array_equal(kept, kept_ref)
    # every token chose expert 0; C = ceil(Tg / E * 1.25) of each group's Tg
    # tokens are kept, the first ones
    T, G = B * S, _num_groups(B * S)
    Tg = T // G
    logits = x.reshape(G, Tg, -1) @ w
    assert (logits.argmax(-1) == 0).all()
    C = int(np.ceil(Tg / cfg.moe.num_experts * cfg.moe.capacity_factor))
    assert C < Tg
    first_c = np.zeros((G, Tg), bool)
    first_c[:, :C] = True
    np.testing.assert_array_equal(kept.reshape(G, Tg), first_c)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, jp, cfg, tp = _models(arch, WEIGHT_MUL)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _ = forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert len(np.unique(np.asarray(want).argmax(-1))) > 3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, jp, cfg, tp = _models(arch, WEIGHT_MUL)
    B, S, T = 2, 9, 24
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jstate = jinit_decode_state(jcfg, B, T)
    want, jstate, _ = jforward(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache=jstate,
                               cache_pos=jnp.zeros((), jnp.int32))
    state = init_decode_state(cfg, B, T, device="cpu")
    got, state = forward(cfg, tp, {"tokens": torch.from_numpy(toks)}, cache=state,
                         cache_pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(state["k"].numpy(), np.asarray(jstate["k"]), **LOGIT_TOL)
    nxt = np.asarray(want[:, -1]).argmax(-1)[:, None].astype(np.int32)
    jdecode = jax.jit(lambda p, s, t, pos: jdecode_step(jcfg, p, s, t, pos))
    for i in range(4):
        want, jstate = jdecode(jp, jstate, jnp.asarray(nxt), jnp.asarray(S + i, jnp.int32))
        got, state = decode_step(cfg, tp, state, torch.from_numpy(nxt), S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_allclose(state["v"].numpy(), np.asarray(jstate["v"]), **LOGIT_TOL)


def _ref_layout(tree):
    """The port's tree as numpy leaves keyed like the reference's."""
    tree = tree_map(lambda a: a.detach().float().numpy(), tree)
    layers = tree.pop("layers")
    tree["layers"] = tree_map(lambda *xs: np.stack(xs), layers[0], *layers[1:])
    return tree_flatten_with_keys(tree)


def _jax_flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a, dtype=np.float32)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad(arch):
    jcfg, jp, cfg, tp = _models(arch, GRAD_MUL, loss_chunk=8, vocab_size=250)
    batch = JPipeline(JDataConfig(vocab_size=250, seq_len=32, global_batch=2))._batch_at(0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, leaves))
    got = _ref_layout(tree_map(lambda _: next(grads), tp))
    assert set(metrics) == set(jm) == {"ce", "load_balance", "router_z", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), err_msg=k, **GRAD_TOL)
    want = _jax_flat(jg)
    assert set(got) == set(want)
    assert any("router" in k for k in want) and any("experts" in k for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)
    # the aux terms reach the router: its gradient is not the cross entropy's alone
    assert float(metrics["loss"].detach()) > float(metrics["ce"].detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_leaf_dtypes(arch):
    """The port's bf16 init, and a bf16 reference tree converted, have the
    reference's leaf dtypes (the router f32); a bf16 forward runs."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    want = jax.eval_shape(lambda: jinit_params(jax.random.key(0), jcfg))
    dtypes = {"/".join(str(k.key) for k in path): str(a.dtype)
              for path, a in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert dtypes["layers/moe/router/w"] == "float32"
    tree = jax.tree.map(np.asarray, jinit_params(jax.random.key(0), jcfg))
    for params in (init_params(cfg, seed=0, device="cpu"),
                   from_jax_params(tree, cfg, device="cpu")):
        got = {k: str(v).split(".")[-1]
               for k, v in tree_flatten_with_keys(tree_map(lambda a: a.dtype,
                                                           _stack_layers(params))).items()}
        assert got == dtypes
        shapes = {k: tuple(v.shape) for k, v in tree_flatten_with_keys(
            _stack_layers(params)).items()}
        assert shapes == {"/".join(str(k.key) for k in path): a.shape
                          for path, a in jax.tree_util.tree_flatten_with_path(want)[0]}
        toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 8)))
        out, _ = forward(cfg, params, {"tokens": toks})
        assert torch.isfinite(out).all()


def _stack_layers(params):
    tree = dict(params)
    layers = tree.pop("layers")
    tree["layers"] = tree_map(lambda *xs: torch.stack(xs), layers[0], *layers[1:])
    return tree


def test_server_streams_match_reference():
    """Reduced llama4-scout through both servers on the same weights: equal
    token streams, and the reference's cross-slot write mirrored (a prompt
    served beside a shorter one decodes differently from alone)."""
    jcfg, jp, cfg, tp = _models("llama4-scout-17b-a16e", WEIGHT_MUL)
    jsrv = JBatchedServer(jcfg, jp, JServerConfig(**SCFG))
    srv = BatchedServer(cfg, tp, ServerConfig(**SCFG), device="cpu")

    def serve(server, prompts):
        server.reset()
        for p in prompts:
            server.submit(p)
        return dict(server.run_until_drained())

    rng = np.random.default_rng(0)
    p5, p9 = rng.integers(0, 256, 5), rng.integers(0, 256, 9)
    alone_ref, alone = serve(jsrv, [p9]), serve(srv, [p9])
    beside_ref, beside = serve(jsrv, [p5, p9]), serve(srv, [p5, p9])
    assert alone == alone_ref
    assert beside == beside_ref
    assert beside[1] != alone[0]
    prompts = [p9, p5, p5[::-1].copy(), p9[::-1].copy()]
    got = serve(srv, prompts)
    assert got == serve(jsrv, prompts)
    assert sorted(got) == [0, 1, 2, 3]
    assert all(len(v) == SCFG["max_new_tokens"] for v in got.values())


def test_expert_parallel_and_active_param_count_match_reference():
    for name in list_archs():
        cfg, jcfg = get_config(name), jget_config(name)
        assert active_param_count(cfg) == jactive_param_count(jcfg), name
        if cfg.moe is None:
            with pytest.raises(ValueError, match="no MoE block") as err:
                expert_parallel(cfg, "ep")
            with pytest.raises(ValueError) as jerr:
                jexpert_parallel(jcfg, "ep")
            assert str(err.value) == str(jerr.value)
            continue
        for axis in ("data", "ep"):
            got = dataclasses.asdict(expert_parallel(cfg, axis))
            assert got == dataclasses.asdict(jexpert_parallel(jcfg, axis)), (name, axis)
            assert got["moe"]["expert_axis"] == axis
        assert dataclasses.asdict(expert_parallel(cfg)) == dataclasses.asdict(
            jexpert_parallel(jcfg))
    scout = get_config("llama4-scout-17b-a16e")
    assert active_param_count(scout) < active_param_count(dataclasses.replace(
        scout, moe=dataclasses.replace(scout.moe, top_k=2)))


@pytest.fixture
def world_of_one(tmp_path):
    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=1, rank=0, store_path=str(tmp_path / "store"))
    try:
        yield FactorizedMesh([1], ("ep",))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_block_in_a_world_of_one_rank(world_of_one, arch):
    """Under a context whose mesh has the expert axis the block dispatches
    through ``api.all_to_all`` (a one-rank exchange copies) and equals the
    one-device block bit for bit, gradients included; without the axis in
    the mesh it is the one-device block."""
    _, _, cfg, tp = _block(arch)
    ep_cfg = expert_parallel(cfg, "ep")
    x = torch.from_numpy(_x(2, 21, cfg.d_model))
    leaves = tree_leaves(tp)

    def run(c, **ctx):
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        with tapi.comm_context(**ctx) as handle:
            out, aux = moe_block(tp, c, xx)
            (out.square().sum() + aux["load_balance"] + aux["router_z"]).backward()
        return out.detach(), aux, [xx.grad] + [p.grad for p in leaves], handle

    want, want_aux, want_g, _ = run(cfg, mesh=world_of_one, axis_names=("ep",))
    got, aux, got_g, ctx = run(ep_cfg, mesh=world_of_one, axis_names=("ep",))
    assert torch.equal(got, want)
    assert all(torch.equal(aux[k].detach(), want_aux[k].detach()) for k in aux)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    assert {p.collective for p in ctx.plans()} >= {"a2a"}
    # the expert axis is not in the mesh: no exchange, the one-device block
    off, _, _, ctx = run(expert_parallel(cfg, "tp"), mesh=world_of_one, axis_names=("ep",))
    assert torch.equal(off, want) and ctx.plans() == []
