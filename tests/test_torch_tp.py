"""The port's tensor-parallel layer against the reference, in one process.

* ``tp_block_specs`` against the reference's ``PartitionSpec``s, leaf by
  leaf, and ``shard_tp_layer`` against the slices those specs give on
  meshes [8] and [2, 4] (the axis tuple in both orders), rank by rank;
* the numpy layers of ``tests/subproc/torch_tp_cases.py`` in the
  reference's ``_layer_init`` layout;
* ``plan_tp_fusion`` equal to the reference's over a grid of meshes,
  shapes, item sizes, weight counts and links tables; the TP ops' refusal
  of a scope without a mesh; ``_tp_local_cfg``'s refusal of indivisible
  heads;
* every new op in a world of one gloo rank (the card's world: size-1 axes,
  rings of no hops): the fused ops and their gradients against the plain
  composition, ``sharded_decode_attention`` against full attention, the
  mesh's ``pmax``, ZeRO-1, and ``transformer_block_tp`` (TP and SP) against
  ``transformer_block_ref``.

The 8-rank world is ``tests/test_torch_tp_exec.py``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.comms.api as japi
import repro.core as jcore
import repro.models.model as jmodel
import repro_torch.comms.api as tapi
import repro_torch.core as tcore
from repro.configs import get_config as jget_config
from repro.models.mlp import plan_tp_fusion as jplan_tp_fusion
from repro_torch.configs import get_config, reduced
from repro_torch.models import (
    init_params,
    shard_tp_layer,
    tp_block_specs,
    transformer_block_ref,
    transformer_block_tp,
)
from repro_torch.models.attention import attention_tp_out_sp
from repro_torch.models.mlp import ffn_apply_tp_sp, plan_tp_fusion
from repro_torch.models.model import _tp_local_cfg

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "subproc"))

import torch_tp_cases as C  # noqa: E402

SMALL = ("granite", "bias", "qknorm")
MESH_NAMES = {"8": ("8", ("t",)), "2x4": ("2x4", ("ta", "tb")),
              "2x4-ba": ("2x4", ("tb", "ta"))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(name):
    return dataclasses.replace(jget_config("granite-3-2b"), **C.config_fields(name))


def _layer(name, seed=0):
    return C.layer_init(C.config_fields(name), np.random.default_rng(seed))


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _split_dim(spec, names):
    """The dimension a reference PartitionSpec splits over ``names``."""
    dims = [i for i, s in enumerate(spec) if s is not None]
    if not dims:
        return None
    assert len(dims) == 1 and tuple(spec[dims[0]]) == tuple(names), spec
    return dims[0]


@pytest.mark.parametrize("name", SMALL)
def test_case_layers_have_the_reference_layout(name):
    want = jax.eval_shape(lambda: jmodel._layer_init(jax.random.key(0), _jcfg(name),
                                                     dtype=jnp.float32))
    got = _layer(name)
    want_leaves = dict(_paths(want))
    got_leaves = dict(_paths(got))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, a in want_leaves.items():
        assert got_leaves[path].shape == a.shape and got_leaves[path].dtype == a.dtype, path


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
@pytest.mark.parametrize("name", SMALL)
def test_tp_block_specs_match_reference(name, sp):
    names = ("ta", "tb")
    layer = _layer(name)
    jx, jspecs = jmodel.tp_block_specs(layer, names, sequence_parallel=sp)
    x_split, specs = tp_block_specs(_to_torch(layer), sequence_parallel=sp)
    assert x_split == _split_dim(tuple(jx), names) if sp else x_split is None
    assert tuple(jx) == ((None, names, None) if sp else ())
    for path, a in _paths(layer):
        want = _split_dim(tuple(_get(jspecs, path)), names)
        got = _get(specs, path)
        got = None if got is None else got % a.ndim
        assert got == want, path


class _MeshStub:
    """A rank's view of a mesh: only what ``shard_tp_layer`` asks."""

    def __init__(self, mesh, rank):
        factors, axes = C.MESHES[mesh]
        self.factors, self.axes = factors, axes
        self.coords = dict(zip(axes, np.unravel_index(rank, factors)))

    def axis_size(self, names):
        return int(np.prod([self.factors[self.axes.index(n)] for n in names]))

    def axis_index(self, names):
        idx = 0
        for n in names:
            idx = idx * self.factors[self.axes.index(n)] + int(self.coords[n])
        return idx


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
@pytest.mark.parametrize("tag", MESH_NAMES)
def test_shard_tp_layer_takes_the_partition_spec_block(tag, sp):
    """Rank r's slice is the block a PartitionSpec with the axis tuple
    gives device r: block ``index over names`` of the split dimension."""
    mesh, names = MESH_NAMES[tag]
    layer = _layer("bias")
    _, jspecs = jmodel.tp_block_specs(layer, names, sequence_parallel=sp)
    _, specs = tp_block_specs(_to_torch(layer), sequence_parallel=sp)
    idx = C.block_index(mesh, names)
    for rank in range(C.WORLD):
        local = shard_tp_layer(_to_torch(layer), specs, _MeshStub(mesh, rank), names)
        for path, a in _paths(layer):
            dim = _split_dim(tuple(_get(jspecs, path)), names)
            want = a if dim is None else np.split(a, C.WORLD, axis=dim)[idx[rank]]
            np.testing.assert_array_equal(_get(local, path).numpy(), want,
                                          err_msg=f"rank {rank} {path}")


FUSION_MESHES = {"8": ((8,), ("x",)), "2x4": ((2, 4), ("a", "b")),
                 "4x2": ((4, 2), ("a", "b")), "2x2x2": ((2, 2, 2), ("a", "b", "c"))}


@pytest.mark.parametrize("key", FUSION_MESHES)
def test_plan_tp_fusion_matches_reference(key):
    """The fuse decision over a grid, with the default links and with a
    links table installed in a nested scope.  The reference decides inside
    shard_map, whose axis env gives the sizes; here both scopes carry them
    as ``axis_sizes``."""
    factors, names = FUSION_MESHES[key]
    sizes = dict(zip(names, factors))
    slow = {names[0]: ("slow", 1e9, 1e-5)}
    decisions = set()
    for links in (None, slow):
        jl = None if links is None else {a: jcore.LinkSpec(*s) for a, s in links.items()}
        tl = None if links is None else {a: tcore.LinkSpec(*s) for a, s in links.items()}
        for rows in (1, 16, 256, 4096, 65536):
            for d_in, d_out in ((64, 256), (2048, 8192), (8192, 2048)):
                for itemsize in (2, 4):
                    for nm in (1, 2, 3):
                        with japi.comm_context(axis_names=names, axis_sizes=sizes):
                            want = (jplan_tp_fusion(names, rows, d_in, d_out, itemsize,
                                                    n_matmuls=nm) if jl is None else
                                    japi.CommContext(axis_names=names, links=jl,
                                                     axis_sizes=sizes).decide_fuse(
                                        names, rows, d_in, d_out, itemsize,
                                        n_matmuls=nm, fuse="auto"))
                        with tapi.comm_context(axis_names=names, axis_sizes=sizes), \
                                tapi.comm_context(links=tl):
                            got = plan_tp_fusion(names, rows, d_in, d_out, itemsize,
                                                 n_matmuls=nm)
                        assert got == want, (links, rows, d_in, d_out, itemsize, nm)
                        decisions.add(got)
    assert decisions == {True, False}  # the grid crosses the overlap model's line


def _meshless_calls():
    w, x = torch.zeros(8, 8), torch.zeros(1, 8, 8)
    p = {k: {"w": w} for k in ("gate", "up", "down", "wo")}
    return {
        "allgather_matmul": lambda: tapi.allgather_matmul(x, w, axis=1),
        "matmul_reduce_scatter": lambda: tapi.matmul_reduce_scatter(x, w, axis=1),
        "ffn_apply_tp_sp": lambda: ffn_apply_tp_sp(p, x),
        "attention_tp_out_sp": lambda: attention_tp_out_sp(p, x),
    }


@pytest.mark.parametrize("op", sorted(_meshless_calls()))
def test_tp_ops_need_a_mesh(op):
    """The reference's scope plans from its shard_map axis env; the port
    has no ambient mesh, so a scope with links and sizes but no mesh plans
    and refuses to run."""
    with tapi.comm_context(axis_names=("a",), axis_sizes={"a": 1},
                           links={"a": tcore.LinkSpec("slow", 1e9, 1e-5)}):
        with pytest.raises(ValueError, match="needs a mesh"):
            _meshless_calls()[op]()


@pytest.mark.parametrize("n", [3, 16])
def test_tp_local_cfg_refuses_indivisible_heads_like_reference(n):
    cfg = reduced(get_config("granite-3-2b"))  # 4 heads, 2 kv heads
    jcfg = dataclasses.replace(jget_config("granite-3-2b"), num_heads=4, num_kv_heads=2)
    with pytest.raises(ValueError) as got:
        _tp_local_cfg(cfg, n)
    with pytest.raises(ValueError) as want:
        jmodel._tp_local_cfg(jcfg, n)
    assert str(got.value) == str(want.value)
    assert _tp_local_cfg(cfg, 2).num_heads == 2 and _tp_local_cfg(cfg, 2).num_kv_heads == 1


# --------------------------------------------------------------------------
# a world of one gloo rank
# --------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=1, rank=0, store_path=str(tmp_path / "store"))
    try:
        yield FactorizedMesh([1, 1], ("a", "b"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("fuse", [True, False, "auto"])
def test_fused_ops_and_gradients_in_a_world_of_one_rank(world_of_one, fuse):
    mesh = world_of_one
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-8, 8, (2, 4, 8), generator=g).float().requires_grad_(True)
    w0, w1 = (torch.randint(-8, 8, (8, 6), generator=g).float().requires_grad_(True)
              for _ in range(2))
    v = torch.randint(-8, 8, (6, 8), generator=g).float().requires_grad_(True)
    h = torch.randint(-8, 8, (2, 4, 6), generator=g).float().requires_grad_(True)
    with tapi.comm_context(mesh, ("a", "b"), fuse=fuse):
        gx, (o0, o1) = tapi.allgather_matmul(x, (w0, w1), axis=1)
        gs, os_ = tapi.allgather_matmul(x, w0, axis=1)
        y = tapi.matmul_reduce_scatter(h, v, axis=1)
        loss = (gx * 3).sum() + (o0 * o0).sum() + o1.sum() + (os_ * 2).sum() + (y * y).sum()
        got = torch.autograd.grad(loss, (x, w0, w1, h, v))
    assert torch.equal(gx, x) and torch.equal(gs, x)
    assert torch.equal(o0, x @ w0) and torch.equal(o1, x @ w1) and torch.equal(os_, x @ w0)
    assert torch.equal(y, h @ v)
    plain = ((x * 3).sum() + ((x @ w0) ** 2).sum() + (x @ w1).sum() + (x @ w0 * 2).sum()
             + ((h @ v) ** 2).sum())
    want = torch.autograd.grad(plain, (x, w0, w1, h, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_decode_pmax_and_zero1_in_a_world_of_one_rank(world_of_one):
    from repro_torch.comms import sharded_decode_attention
    from repro_torch.kernels import ref as kref
    from repro_torch.optim import zero1_shard_grads, zero1_unshard_params

    mesh = world_of_one
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
            for _ in range(2))
    with tapi.comm_context(mesh, ("a", "b")):
        for valid in (1, 20, 32):
            got = sharded_decode_attention(q, k, v, axis_name="b", valid_len=valid)
            mask = (torch.arange(32) < valid)[None].expand(2, 32)
            want = kref.flash_attention(q, k, v, causal=False, kv_mask=mask)
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        grads = {"w": torch.arange(24.0).reshape(8, 3), "b": torch.arange(5.0)}
        sharded = zero1_shard_grads(grads, ("a", "b"), num_chunks=2)
        full = zero1_unshard_params(sharded, ("a", "b"), reference=grads)
        assert all(torch.equal(full[key], grads[key]) for key in grads)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    assert torch.equal(mesh.pmax(x, ("a", "b")), x)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
@pytest.mark.parametrize("fuse", [True, False])
def test_transformer_block_tp_in_a_world_of_one_rank(world_of_one, sp, fuse):
    mesh = world_of_one
    cfg = dataclasses.replace(reduced(get_config("granite-3-2b")), qkv_bias=True)
    layer = init_params(cfg, device="cpu")["layers"][0]
    for leaf in (layer["attn"]["wq"], layer["attn"]["wk"], layer["attn"]["wv"]):
        leaf["b"] = torch.randn(leaf["b"].shape, generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(2))
    pos = torch.arange(16).expand(2, 16)
    want = transformer_block_ref(layer, cfg, x, positions=pos)
    x_split, specs = tp_block_specs(layer, sequence_parallel=sp)
    local = shard_tp_layer(layer, specs, mesh, ("a", "b"))
    with tapi.comm_context(mesh, ("a", "b"), fuse=fuse) as ctx:
        got = transformer_block_tp(local, cfg, x, positions=pos, sequence_parallel=sp)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert {p.collective for p in ctx.plans()} == ({"ag", "rs"} if sp else {"ar"})
