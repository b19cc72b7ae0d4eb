"""The port's sharding specs (``repro_torch.models.sharding``,
``repro_torch.optim.opt_state_specs``) held entry for entry to the
reference's, and their DTensor side in a world of one gloo rank.

The spec functions read only ``mesh.shape``, so one stand-in mesh (an object
whose ``shape`` maps axis names to sizes) serves both packages.  Parameter
trees are the reduced configs' in both packages (the reference's as
``jax.eval_shape`` structures: nothing is computed).  The reference stacks
its layers, the port keeps a list: each port layer leaf gets the reference's
stacked spec without its leading ``None``, and a function given the
reference's stacked specs and shapes returns what the reference's does.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs, reduced
from repro_torch.models import init_params
from repro_torch.models import sharding as shd
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim import opt_state_specs

ARCHS = list_archs()
MESHES = {
    "d2m4": {"data": 2, "model": 4},
    "p2d2m2": {"pod": 2, "data": 2, "model": 2},
    "d16m16": {"data": 16, "model": 16},
    "p2d16m16": {"pod": 2, "data": 16, "model": 16},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


_TREES = {}


def _trees(arch):
    """(reference shapes, stacked; port params, layers as a list)."""
    if arch not in _TREES:
        import jax
        from repro.configs import get_config as jget, reduced as jreduced
        from repro.models import init_params as jinit

        jcfg = dataclasses.replace(jreduced(jget(arch)), dtype="float32")
        ref = jax.eval_shape(lambda: jinit(jax.random.key(0), jcfg))
        _TREES[arch] = (ref, init_params(_cfg(arch), seed=0, device="cpu"))
    return _TREES[arch]


def _port_spec_tree(jtree):
    """A tree of the reference's PartitionSpecs as port specs."""
    from jax.sharding import PartitionSpec

    if isinstance(jtree, dict):
        return {k: _port_spec_tree(v) for k, v in jtree.items()}
    assert isinstance(jtree, PartitionSpec), jtree
    return shd.P(*tuple(jtree))


def _entries(tree, prefix=""):
    """{"/"-joined key: tuple(spec)} of a tree of specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_entries(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_entries(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


def _per_layer(ref_entries, num_layers):
    """The reference's stacked entries as the port's: a layer leaf once per
    layer, without its leading (layer) entry, which must be None."""
    out = {}
    for k, spec in ref_entries.items():
        if k.startswith("layers/"):
            assert spec[0] is None, (k, spec)
            for i in range(num_layers):
                out[f"layers/{i}/{k[len('layers/'):]}"] = spec[1:]
        else:
            out[k] = spec
    return out


def _stacked_port_specs(port_specs):
    out = dict(port_specs)
    out["layers"] = shd.map_specs(lambda s: shd.P(None, *s), port_specs["layers"][0])
    return out


# ---- the spec type ----------------------------------------------------------

def test_spec_entries_are_normalised_as_jax_does():
    from jax.sharding import PartitionSpec

    for entries in [(), (None,), ("data", None), (("data",), None), (("pod", "data"), "model"),
                    ((), None, "model"), (["pod", "data"],)]:
        assert tuple(shd.P(*entries)) == tuple(PartitionSpec(*entries)), entries
    assert repr(shd.P("data", None)) == "P('data', None)"


# ---- parameter specs ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_layer_by_layer(arch):
    from repro.models import sharding as jshd

    ref, params = _trees(arch)
    want = _per_layer(_entries(jshd.param_specs(None, ref)), len(params["layers"]))
    got = _entries(shd.param_specs(_cfg(arch), params))
    assert got == want
    assert any("model" in spec for spec in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["granite-3-2b", "llama4-scout-17b-a16e", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_sanitize_fsdp_and_opt_state_specs_equal_reference(arch, mesh):
    from repro.models import sharding as jshd
    from repro.optim import opt_state_specs as jopt_state_specs

    m = SimpleNamespace(shape=MESHES[mesh])
    ref, params = _trees(arch)
    jspecs = jshd.sanitize_tree(jshd.param_specs(None, ref), ref, m)
    # the same inputs (the reference's stacked specs and shapes)
    stacked = _port_spec_tree(jshd.param_specs(None, ref))
    got = shd.sanitize_tree(stacked, ref, m)
    assert _entries(got) == _entries(jspecs)
    assert _entries(shd.fsdp_tree(got, ref, m)) == _entries(jshd.fsdp_tree(jspecs, ref, m))
    jopt = jopt_state_specs(jspecs, ref, m)
    opt = opt_state_specs(got, ref, m)
    assert _entries(opt) == _entries(jopt)
    assert _entries(opt_state_specs(got, ref, m, with_master=False)) == _entries(
        jopt_state_specs(jspecs, ref, m, with_master=False))
    # the port's own trees: layers as a list, the same specs a layer
    port = shd.sanitize_tree(shd.param_specs(_cfg(arch), params), params, m)
    assert _entries(port) == _per_layer(_entries(jspecs), len(params["layers"]))
    assert _entries(_stacked_port_specs(port)) == _entries(jspecs)


@pytest.mark.parametrize("spec,shape", [
    (("data", None, "model"), (4, 6, 8)), ((None, "model"), (3, 16)),
    ((("pod", "data"), None), (8, 5)), ((None, None), (7, 7)), ((), (4, 4))])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zero1_spec_equals_reference(spec, shape, mesh):
    from jax.sharding import PartitionSpec

    from repro.optim.adamw import _zero1_spec as j_zero1_spec

    data = MESHES[mesh]["data"]
    assert tuple(adamw_mod._zero1_spec(shd.P(*spec), shape, data)) == tuple(
        j_zero1_spec(PartitionSpec(*spec), shape, data))


# ---- batch, cache and logits specs -------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_logits_specs_equal_reference(arch, mesh):
    from repro.configs import SHAPES as JSHAPES, get_config as jget
    from repro.models import sharding as jshd

    m = SimpleNamespace(shape=MESHES[mesh])
    cfg, jcfg = get_config(arch), jget(arch)
    for name in SHAPES:
        got = {k: tuple(v) for k, v in shd.batch_specs(cfg, SHAPES[name], m).items()}
        want = {k: tuple(v) for k, v in jshd.batch_specs(jcfg, JSHAPES[name], m).items()}
        assert got == want, name
    assert _entries(shd.cache_specs(cfg, m)) == _entries(
        _port_spec_tree(jshd.cache_specs(jcfg, m)))
    assert tuple(shd.logits_spec(m)) == tuple(jshd.logits_spec(m))
    assert shd.dp_axes(m) == jshd.dp_axes(m)


@pytest.mark.parametrize("kv_shard", ["heads", "seq"])
def test_cache_specs_follow_kv_shard_as_reference(kv_shard):
    from repro.configs import get_config as jget
    from repro.models import sharding as jshd

    m = SimpleNamespace(shape=MESHES["d2m4"])
    cfg = dataclasses.replace(get_config("granite-3-2b"), kv_shard=kv_shard)
    jcfg = dataclasses.replace(jget("granite-3-2b"), kv_shard=kv_shard)
    assert _entries(shd.cache_specs(cfg, m)) == _entries(
        _port_spec_tree(jshd.cache_specs(jcfg, m)))


# ---- constrain --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["hidden", "logits", "tokens_flat", "moe_buffer", "other"])
def test_constrain_is_the_identity_on_plain_tensors(kind):
    x = torch.randn(2, 4, 8)
    shd.set_activation_policy(None)
    assert shd.constrain(x, kind) is x
    shd.set_activation_policy({"dp": ("data",), "tp": "model", "sequence_parallel": True})
    try:
        assert shd.constrain(x, kind) is x
    finally:
        shd.set_activation_policy(None)


def test_model_outputs_unchanged_under_a_policy():
    """Plain tensors take the same path with or without a policy: bit for bit."""
    from repro_torch.models import forward

    cfg = _cfg("granite-3-2b")
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    plain, _ = forward(cfg, params, {"tokens": tokens})
    shd.set_activation_policy({"dp": ("data",), "tp": "model", "sequence_parallel": True})
    try:
        hinted, _ = forward(cfg, params, {"tokens": tokens})
    finally:
        shd.set_activation_policy(None)
    assert torch.equal(plain, hinted)


# ---- placements ---------------------------------------------------------------

def _stand_in(names):
    return SimpleNamespace(mesh_dim_names=names, shape=(1,) * len(names))


@pytest.mark.parametrize("spec,names,want", [
    (("data", None, "model"), ("data", "model"), ["S0", "S2"]),
    ((None, "model"), ("data", "model"), ["R", "S1"]),
    ((("pod", "data"), None), ("pod", "data", "model"), ["S0", "S0", "R"]),
    ((), ("pod", "data", "model"), ["R", "R", "R"]),
    ((None, None, ("data", "model")), ("data", "model"), ["S2", "S2"]),
])
def test_to_placements(spec, names, want):
    from torch.distributed.tensor import Replicate, Shard

    def code(p):
        return "R" if isinstance(p, Replicate) else f"S{p.dim}" if isinstance(p, Shard) else p

    assert [code(p) for p in shd.to_placements(shd.P(*spec), _stand_in(names))] == want


@pytest.mark.parametrize("spec,names,match", [
    ((("data", "pod"), None), ("pod", "data", "model"), "mesh's order"),
    (("pod", None), ("data", "model"), "lacks"),
    (("data", "data"), ("data", "model"), "twice"),
])
def test_to_placements_refuses(spec, names, match):
    with pytest.raises(ValueError, match=match):
        shd.to_placements(shd.P(*spec), _stand_in(names))


def test_axis_sizes_of_a_device_mesh_stand_in():
    m = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
    assert dict(shd.axis_sizes(m)) == {"data": 2, "model": 4}
    assert shd.dp_axes(m) == ("data",)


# ---- a world of one gloo rank ---------------------------------------------------

@pytest.fixture
def mesh_of_one(tmp_path):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=1, rank=0, store_path=str(tmp_path / "store"))
    try:
        yield (DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model")),
               FactorizedMesh([1, 1], ("data", "model")))
    finally:
        shd.set_activation_policy(None)
        torch.distributed.destroy_process_group()


def _dt(x, mesh, *placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, list(placements), src_data_rank=None)


def test_distribute_tree_places_by_spec(mesh_of_one):
    from torch.distributed.tensor import Replicate, Shard

    mesh, _ = mesh_of_one
    cfg = _cfg("granite-3-2b")
    params = init_params(cfg, seed=0, device="cpu")
    specs = shd.sanitize_tree(shd.param_specs(cfg, params), params, mesh)
    placed = shd.distribute_tree(params, specs, mesh)
    wq = placed["layers"][1]["attn"]["wq"]["w"]
    assert list(wq.placements) == [Replicate(), Shard(1)]
    assert torch.equal(wq.full_tensor(), params["layers"][1]["attn"]["wq"]["w"])
    assert list(placed["embed"].placements) == [Replicate(), Shard(0)]


def test_stack_and_unstack_layers_share_storage(mesh_of_one):
    from torch.distributed.tensor import Replicate, Shard

    mesh, _ = mesh_of_one
    layers = [{"w": _dt(torch.full((4, 6), float(i)), mesh, Replicate(), Shard(1))}
              for i in range(3)]
    stacked = shd.stack_layers(layers)
    assert list(stacked["w"].placements) == [Replicate(), Shard(2)]
    assert stacked["w"].shape == (3, 4, 6)
    views = shd.unstack_layers(stacked, layers)
    assert list(views[2]["w"].placements) == [Replicate(), Shard(1)]
    with torch.no_grad():
        stacked["w"].mul_(2)
    assert torch.equal(views[2]["w"].full_tensor(), torch.full((4, 6), 4.0))
    with pytest.raises(ValueError, match="layer dim is sharded"):
        shd.unstack_layers({"w": _dt(torch.zeros(3, 4), mesh, Shard(0), Replicate())},
                           [{"w": None}] * 3)


def test_whole_groups_keeps_even_splits(mesh_of_one):
    from torch.distributed.tensor import Replicate, Shard

    mesh, _ = mesh_of_one
    x = _dt(torch.randn(2, 3, 8), mesh, Shard(0), Shard(2))
    assert shd.whole_groups(x, -1, 4) is x  # a split of 1 cuts nothing
    plain = torch.randn(2, 8)
    assert shd.whole_groups(plain, -1, 3) is plain
    assert shd.whole_sequence(plain) is plain
    seq = _dt(torch.randn(2, 3, 8), mesh, Shard(0), Shard(1))
    assert list(shd.whole_sequence(seq).placements) == [Shard(0), Replicate()]
    assert shd.whole_sequence(x) is x


@pytest.mark.parametrize("kind,spec", [("hidden", ("data", None, None)),
                                       ("logits", ("data", None, "model"))])
def test_constrain_redistributes_a_dtensor(mesh_of_one, kind, spec):
    mesh, _ = mesh_of_one
    x = _dt(torch.randn(2, 4, 8), mesh, *shd.to_placements(shd.P(None, None, None), mesh))
    shd.set_activation_policy({"dp": ("data",), "tp": "model", "sequence_parallel": False})
    y = shd.constrain(x, kind)
    assert list(y.placements) == shd.to_placements(shd.P(*spec), mesh)
    assert torch.equal(y.full_tensor(), x.full_tensor())


def _kernel_cases():
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    B, H, S, hd = 2, 4, 8, 16
    w = torch.sigmoid(rnd(B, H, S, hd))
    x = rnd(B, S, H, hd)
    return {
        "rmsnorm": (lambda a, s: ops.rmsnorm(a, s, eps=1e-5), (rnd(B, S, 32), rnd(32))),
        "swiglu": (ops.swiglu, (rnd(B, S, 32), rnd(B, S, 32))),
        "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                            (rnd(B, H, S, hd), rnd(B, 2, S, hd), rnd(B, 2, S, hd))),
        "wkv6": (ops.rwkv6_scan, (rnd(B, H, S, hd), rnd(B, H, S, hd), rnd(B, H, S, hd), w,
                                  rnd(H, hd), None)),
        "mamba2_ssd": (ops.mamba2_ssd_scan, (x, rnd(B, S, 8), rnd(B, S, 8),
                                             torch.rand(B, S, H, generator=g),
                                             torch.rand(B, S, H, generator=g), None)),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "swiglu", "flash_attention", "wkv6", "mamba2_ssd"])
def test_kernel_wrappers_take_dtensors(mesh_of_one, name):
    """A DTensor runs the wrapper on its local shard: the plain call's
    output bit for bit, at the input's placements, with gradients."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, _ = mesh_of_one
    fn, args = _kernel_cases()[name]
    want = fn(*args)
    lead = [Shard(0), Replicate()]  # batch over data
    placed = [None if a is None else _dt(a.clone().requires_grad_(a.dim() > 1), mesh, *(
        lead if i == 0 or a.dim() == args[0].dim() else [Replicate(), Replicate()]))
        for i, a in enumerate(args)]
    got = fn(*placed)
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for o, w in zip(outs, wants):
        assert o.shape == w.shape
        assert torch.equal(o.full_tensor(), w)
    assert list(outs[0].placements) == lead
    outs[0].sum().backward()
    assert placed[0].grad is not None and placed[0].grad.shape == args[0].shape


def test_kernel_rules_accept_what_the_kernels_split():
    """Each rule keeps the splits its kernel takes and replicates the rest."""
    from types import SimpleNamespace as NS

    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels import local

    mesh = NS(shape=(2, 4))

    def t(shape, *pl):
        return NS(placements=list(pl), dim=lambda: len(shape), shape=shape, device_mesh=mesh)

    x = t((2, 8, 32), Shard(0), Shard(2))
    ins, grads, outs = local.rmsnorm_rule(x, t((32,), Replicate(), Replicate()))
    assert ins[0] == [Shard(0), Replicate()] and outs == [[Shard(0), Replicate()]]
    assert grads[1] == [Partial(), Replicate()]
    q = t((2, 4, 8, 16), Shard(0), Shard(1))
    ins, _, _ = local.flash_rule(q, t((2, 2, 8, 16)), t((2, 2, 8, 16)))
    assert ins[0] == [Shard(0), Replicate()]  # 2 KV heads over 4: the groups would be cut
    ins, _, _ = local.flash_rule(q, t((2, 4, 8, 16)), t((2, 4, 8, 16)))
    assert ins[0] == [Shard(0), Shard(1)]
    r = t((2, 4, 8, 16), Replicate(), Shard(1))
    ins, grads, outs = local.wkv6_rule(r, r, r, r, t((4, 16)), None)
    assert ins[4] == [Replicate(), Shard(0)] and ins[5] is None and outs[1] == [Replicate(), Shard(1)]
    x = t((2, 8, 4, 16), Shard(0), Shard(2))
    ins, grads, outs = local.ssd_rule(x, t((2, 8, 8)), t((2, 8, 8)), t((2, 8, 4)), t((2, 8, 4)),
                                      None)
    assert ins[1] == [Shard(0), Replicate()] and grads[1] == [Shard(0), Partial()]
    assert outs[1] == [Shard(0), Shard(1)]
    ins, _, _ = local.swiglu_rule(t((2, 8, 32), Partial(), Shard(2)), None)
    assert ins[0] == ins[1] == [Replicate(), Shard(2)]


def test_adamw_on_dtensors_equals_plain(mesh_of_one):
    """ZeRO-1 placed state and placed parameters: the plain update bit for
    bit, each leaf left at its placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update

    mesh, _ = mesh_of_one
    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(4, 6, generator=g), "b": torch.randn(8, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    cfg = OptimizerConfig(warmup_steps=1, decay_steps=4)
    want_p = {k: v.clone() for k, v in params.items()}
    want_o = adamw_init(want_p, cfg)
    adamw_update(grads, want_o, want_p, cfg)

    pl = {"a": [Replicate(), Shard(1)], "b": [Replicate(), Replicate()]}
    zl = {"a": [Shard(0), Shard(1)], "b": [Shard(0), Replicate()]}
    got_p = {k: _dt(v.clone(), mesh, *pl[k]) for k, v in params.items()}
    got_o = adamw_init(params, cfg)
    for k in ("m", "v", "master"):
        got_o[k] = {n: _dt(t, mesh, *zl[n]) for n, t in got_o[k].items()}
    got_g = {k: _dt(v, mesh, Partial(), *pl[k][1:]) for k, v in grads.items()}
    adamw_update(got_g, got_o, got_p, cfg)
    for k in params:
        assert list(got_p[k].placements) == pl[k]
        assert list(got_o["m"][k].placements) == zl[k]
        assert torch.equal(got_p[k].full_tensor(), want_p[k])
        for s in ("m", "v", "master"):
            assert torch.equal(got_o[s][k].full_tensor(), want_o[s][k])
    assert int(got_o["step"]) == 1


def test_tree_copy_into_dtensors(mesh_of_one):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.tree import tree_copy_

    mesh, _ = mesh_of_one
    dst = {"w": _dt(torch.zeros(4, 6), mesh, Replicate(), Shard(1))}
    src = {"w": torch.arange(24.0).reshape(4, 6)}
    tree_copy_(dst, src)
    assert torch.equal(dst["w"].full_tensor(), src["w"])
    assert list(dst["w"].placements) == [Replicate(), Shard(1)]


@pytest.mark.parametrize("op,sharded_out", [("all_gather", False), ("reduce_scatter", True),
                                            ("all_reduce", False), ("all_to_all", True)])
def test_global_array_ops(mesh_of_one, op, sharded_out):
    """A DTensor takes the reference's outside-shard_map path: its global
    result (one rank: the input itself) at the reference's out_spec."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.comms import api

    mesh, fmesh = mesh_of_one
    x = torch.arange(64.0).reshape(8, 8)
    d = _dt(x, mesh, Replicate(), Replicate())
    with api.comm_context(fmesh, ("data",)) as ctx:
        y = getattr(api, op)(d, axis=0)
    assert torch.equal(y.full_tensor(), x)
    assert list(y.placements) == [Shard(0) if sharded_out else Replicate(), Replicate()]
    assert {p.collective for p in ctx.plans()} <= {"ag", "rs", "ar", "a2a"}
    # and a plain tensor keeps the local contract
    with api.comm_context(fmesh, ("data",)):
        assert torch.equal(getattr(api, op)(x, axis=0), x)


def test_global_array_op_needs_a_mesh_in_the_reference_words(mesh_of_one):
    from torch.distributed.tensor import Replicate

    from repro.comms import api as japi
    from repro.core import planner as jplanner
    from repro_torch.comms import api
    from repro_torch.core import planner

    mesh, _ = mesh_of_one
    d = _dt(torch.ones(4, 4), mesh, Replicate(), Replicate())
    links = {"data": planner.LinkSpec("fast", 50e9, 1e-6)}
    ctx = api.CommContext(axis_names=("data",), links=links, axis_sizes={"data": 1})
    jctx = japi.CommContext(axis_names=("data",), axis_sizes={"data": 1},
                            links={"data": jplanner.LinkSpec("fast", 50e9, 1e-6)})
    with pytest.raises(ValueError) as want:
        japi._require_mesh(jctx, "this op")
    for op in ("all_gather", "reduce_scatter", "all_reduce", "all_to_all"):
        with pytest.raises(ValueError) as got:
            getattr(api, op)(d, axis=0, ctx=ctx)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch,remat", [
    ("granite-3-2b", None), ("granite-3-2b", "full"), ("granite-3-2b", "dots"),
    ("llama4-scout-17b-a16e", None), ("rwkv6-7b", None), ("zamba2-2.7b", "full")])
def test_spec_step_on_one_rank_equals_the_single_device_step(mesh_of_one, arch, remat):
    """The spec step on a mesh of one rank (every leaf a DTensor, the layers
    stored stacked, activations redistributed under the launcher's policy
    with sequence parallelism, as at full size) against the one-device
    step, with and without remat."""
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime import make_train_step
    from repro_torch.runtime.trainer import make_spec_train_step, place_spec_state
    from repro_torch.tree import tree_leaves

    mesh, _ = mesh_of_one
    cfg = _cfg(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=remat)
    ocfg = OptimizerConfig(warmup_steps=1, decay_steps=3)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab_size, 16, 2))
    batches = [{k: torch.from_numpy(v) for k, v in next(pipe).items()} for _ in range(2)]

    params = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg)
    want = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        want.append(float(m["loss"]))

    shd.set_activation_policy({"dp": ("data",), "tp": "model", "sequence_parallel": True})
    sparams, sopt, stacked = place_spec_state(cfg, ocfg, init_params(cfg, seed=0, device="cpu"),
                                              mesh)
    sstep = make_spec_train_step(cfg, ocfg, mesh, stacked)
    got = []
    for b in batches:
        sparams, sopt, m = sstep(sparams, sopt, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # AdamW's first steps move an element by up to lr (3e-4) whatever its
    # gradient, so an element whose gradient is near zero and differs in its
    # last bits (the sums run in another order) can move differently: the
    # spec training test's PARAM_ATOL
    for a, b in zip(tree_leaves(sparams), tree_leaves(params)):
        np.testing.assert_allclose(a.full_tensor().detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=2e-5)
