"""Run the reference's (JAX) tensor-parallel ops and block on the cases of
``torch_tp_cases``.

    python tests/subproc/torch_tp_ref.py --out OUT.npz

Forces 8 fake CPU devices before jax is imported, builds each mesh with
``repro.comms.make_factorized_mesh`` (asserting that its devices are 0..7
in flat order, so device r holds rank r's shard), and runs each case inside
``shard_map`` under a ``comm_context`` with the case's axes and fusion
policy.  Per-rank inputs go in stacked on a leading axis split over the
mesh's axes; gradients are ``jax.grad`` of the sum over devices of each
device's loss, so device r's gradient is the one rank r's backward gives.
The block runs as the reference's own ``shard_map`` of
``transformer_block_tp`` with ``tp_block_specs``' in_specs, beside
``transformer_block_ref`` on the full layer.  Writes, per case and output,
the devices' arrays stacked (or the global array where the output spec
says so); ``tests/test_torch_tp_exec.py`` compares them with the port's
world.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_tp_cases as C  # noqa: E402
from repro.comms import api, make_factorized_mesh  # noqa: E402
from repro.comms.decode_attention import sharded_decode_attention  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.models.mlp import ffn_apply, ffn_apply_tp, ffn_apply_tp_sp  # noqa: E402
from repro.models.model import (  # noqa: E402
    transformer_block_ref,
    transformer_block_tp,
    tp_block_specs,
)
from repro.optim import zero1_shard_grads, zero1_unshard_params  # noqa: E402


def _cfg(name):
    return dataclasses.replace(get_config("granite-3-2b"), **C.config_fields(name))


def _positions(B, S):
    return jnp.broadcast_to(jnp.arange(S)[None, :], (B, S)).astype(jnp.int32)


def _per_rank_ffn(ffn, case):
    """Rank r's d_ff slice of the full FFN, stacked in rank order: the
    numpy counterpart of tp_block_specs' split (gate/up columns, down
    rows), block ``block_index[r]`` over the case's axes."""
    idx = C.block_index(case["mesh"], case["names"])
    n = C.WORLD

    def cut(a, dim):
        return np.stack([np.split(a, n, axis=dim)[idx[r]] for r in range(n)])

    return {k: {"w": cut(v["w"], 0 if k == "down" else 1)} for k, v in ffn.items()}


#: transformer_block_ref's output by config name
_REF_BLOCK = {}


def run_case(case, mesh):
    """The reference's outputs for ``case`` (a dict of numpy arrays)."""
    kind, names = case["kind"], tuple(case["names"])
    inp = C.inputs(case)
    dev = P(tuple(mesh.axis_names))  # the leading rank axis, device r = rank r
    out = {}
    with api.comm_context(mesh, names, fuse=case["fuse"]):
        if kind == "ops":
            def body(x, w0, w1, h, v):
                x, w0, w1, h, v = x[0], w0[0], w1[0], h[0], v[0]
                g_single, o_single = api.allgather_matmul(x, w0, axis=1)
                g_pair, (o_pair0, o_pair1) = api.allgather_matmul(x, (w0, w1), axis=1)
                y = api.matmul_reduce_scatter(h, v, axis=1)
                return {k: a[None] for k, a in dict(
                    g_single=g_single, o_single=o_single, g_pair=g_pair,
                    o_pair0=o_pair0, o_pair1=o_pair1, y=y).items()}

            out.update(jax.jit(shard_map(body, mesh=mesh, in_specs=(dev,) * 5,
                                         out_specs=dev))(
                *(inp[k] for k in ("x", "w0", "w1", "h", "v"))))
        elif kind == "ops_grad":
            def body(x, w0, w1, h, v, a, cg, c0, c1, cy, ca):
                g, (o0, o1) = api.allgather_matmul(x[0], (w0[0], w1[0]), axis=1)
                y = api.matmul_reduce_scatter(h[0], v[0], axis=1)
                t = api.all_to_all(a[0], axis=0)
                loss = (jnp.sum(g * cg[0]) + jnp.sum(o0 * c0[0]) + jnp.sum(o1 * c1[0])
                        + jnp.sum(y * cy[0]) + jnp.sum(t * ca[0]))
                return loss[None]

            f = shard_map(body, mesh=mesh, in_specs=(dev,) * 11, out_specs=dev)
            names_in = ("x", "w0", "w1", "h", "v", "a")
            cots = tuple(inp[k] for k in ("cg", "c0", "c1", "cy", "ca"))
            grads = jax.jit(jax.grad(lambda *a: f(*a, *cots).sum(),
                                     argnums=tuple(range(6))))(*(inp[k] for k in names_in))
            out.update({f"d{k}": g for k, g in zip(names_in, grads)})
        elif kind in ("ffn_tp", "ffn_tp_grad", "ffn_sp_grad"):
            full = C.layer_of(inp)["ffn"]
            p = _per_rank_ffn(full, case)
            x = inp["x"]
            if kind == "ffn_sp_grad":
                idx = C.block_index(case["mesh"], names)
                xs = np.stack([np.split(x, C.WORLD, axis=1)[idx[r]] for r in range(C.WORLD)])

                def body(xl, pl):
                    y = ffn_apply_tp_sp(jax.tree.map(lambda a: a[0], pl), xl[0])
                    return jnp.sum(y * y)[None]

                f = shard_map(body, mesh=mesh, in_specs=(dev, dev), out_specs=dev)
                dx, dp = jax.jit(jax.grad(lambda a, b: f(a, b).sum(), argnums=(0, 1)))(xs, p)
            else:
                xs = np.broadcast_to(x, (C.WORLD,) + x.shape)

                def fwd(xl, pl):
                    return ffn_apply_tp(jax.tree.map(lambda a: a[0], pl), xl[0])[None]

                f = shard_map(fwd, mesh=mesh, in_specs=(dev, dev), out_specs=dev)
                out["y"] = jax.jit(f)(xs, p)
                out["full"] = jax.jit(ffn_apply)(full, x)
                if kind == "ffn_tp_grad":
                    c = inp["c"]
                    dx, dp = jax.jit(jax.grad(lambda a, b: jnp.sum(f(a, b) * c),
                                              argnums=(0, 1)))(xs, p)
            if kind != "ffn_tp":
                out["dx"] = dx
                out.update({f"d/{k}/w": v["w"] for k, v in dp.items()})
        elif kind == "block":
            cfg = _cfg(case["cfg"])
            layer = C.layer_of(inp)
            x = inp["x"]
            pos = _positions(*x.shape[:2])
            x_spec, l_spec = tp_block_specs(layer, names, sequence_parallel=case["sp"])
            fn = jax.jit(shard_map(
                lambda lx, ll: transformer_block_tp(ll, cfg, lx, positions=pos,
                                                    sequence_parallel=case["sp"]),
                mesh=mesh, in_specs=(x_spec, l_spec), out_specs=x_spec))
            out["out"] = fn(x, layer)
            if case["cfg"] not in _REF_BLOCK:  # one layer and input a config
                _REF_BLOCK[case["cfg"]] = jax.jit(lambda lx, ll: transformer_block_ref(
                    ll, cfg, lx, positions=pos))(x, layer)
            out["ref"] = _REF_BLOCK[case["cfg"]]
        elif kind == "decode":
            q, k, v = inp["q"], inp["k"], inp["v"]
            B, T = q.shape[0], k.shape[2]
            kv = P(None, None, names[0], None)

            def body(qq, kk, vv):
                return {f"out{n}": sharded_decode_attention(
                    qq, kk, vv, axis_name=names[0], valid_len=jnp.asarray(n, jnp.int32))
                    for n in C.DECODE_VALID}

            out.update(jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), kv, kv),
                                         out_specs=P()))(q, k, v))
            for n in C.DECODE_VALID:
                mask = jnp.broadcast_to(jnp.arange(T)[None, :] < n, (B, T))
                out[f"truth{n}"] = kref.flash_attention(q, k, v, causal=False, kv_mask=mask)
        elif kind == "zero1":
            fast, slow = tuple(case["fast"]), tuple(case["slow"])

            def body(gw, gb):
                g = {"w": gw[0], "b": gb[0]}
                sharded = zero1_shard_grads(g, fast, slow, num_chunks=2)
                full = zero1_unshard_params(sharded, fast, reference=g)
                return sharded["w"][None], full["w"][None], full["b"][None]

            sw, w, b = jax.jit(shard_map(body, mesh=mesh, in_specs=(dev, dev),
                                         out_specs=(dev,) * 3))(inp["g/w"], inp["g/b"])
            out.update(scattered_w=sw, w=w, b=b)
        else:
            raise ValueError(kind)
    return {k: np.asarray(v) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    meshes = {}
    for key, (factors, names) in C.MESHES.items():
        mesh = make_factorized_mesh(list(factors), list(names))
        ids = [d.id for d in mesh.devices.flat]
        if ids != list(range(C.WORLD)):
            raise SystemExit(f"mesh {key}: device ids {ids}, want 0..7 in flat order")
        meshes[key] = mesh
    outs = {}
    for case in C.CASES:
        for k, v in run_case(case, meshes[case["mesh"]]).items():
            outs[f"{case['id']}#{k}"] = v
    np.savez(args.out, **outs)
    print(f"[torch_tp_ref] {len(C.CASES)} cases on {jax.device_count()} devices "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
