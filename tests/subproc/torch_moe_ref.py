"""Run the reference's (JAX) expert-parallel MoE block on the cases of
``torch_moe_cases``.

    python tests/subproc/torch_moe_ref.py --out OUT.npz

Forces 8 fake CPU devices before jax is imported, builds each mesh with
``repro.comms.make_factorized_mesh`` (asserting that its devices are 0..7
in flat order, so device r holds rank r's shard), and runs ``moe_block`` of
``expert_parallel(cfg, axis)`` inside ``shard_map`` under a
``comm_context`` of the mesh's axes: x split over every axis on its batch
dim, the weights replicated.  Writes per case the output (global), each
device's aux losses, the plans the context issued, the one-device block
run shard by shard, and for ``grad`` cases ``jax.grad`` of the sum over
devices of ``sum(out * c_r) + load_balance + router_z``.
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

import torch_moe_cases as C  # noqa: E402
from repro.comms import api, make_factorized_mesh  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.configs import ModelConfig, MoEConfig, expert_parallel  # noqa: E402
from repro.models.moe import moe_block  # noqa: E402


def _cfg():
    return ModelConfig(**C.CONFIG, moe=MoEConfig(**C.MOE))


def run_case(case, mesh):
    cfg = _cfg()
    ep_cfg = expert_parallel(cfg, axis=case["axis"])
    inp = C.inputs(case)
    p = jax.tree.map(jnp.asarray, C.params_of(inp))
    x, c = jnp.asarray(inp["x"]), jnp.asarray(inp["c"])
    names = tuple(mesh.axis_names)
    dev = P(names)
    out = {}
    with api.comm_context(mesh, names) as ctx:
        def body(pp, xx):
            y, aux = moe_block(pp, ep_cfg, xx)
            return y, aux["load_balance"][None], aux["router_z"][None]

        f = shard_map(body, mesh=mesh, in_specs=(P(), dev), out_specs=(dev, dev, dev))
        if case["kind"] == "fwd":
            out["out"], out["lb"], out["rz"] = jax.jit(f)(p, x)
            out["plans"] = C.plan_summary(ctx.plans())
            b = x.shape[0] // C.WORLD
            local = [moe_block(p, cfg, x[r * b:(r + 1) * b]) for r in range(C.WORLD)]
            out["local"] = jnp.concatenate([y for y, _ in local], axis=0)
        else:
            def loss(pp, xx):
                y, lb, rz = f(pp, xx)
                cy = c.reshape(y.shape)
                return jnp.sum(y * cy) + jnp.sum(lb) + jnp.sum(rz)

            dp, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
            out["dx"] = dx
            out.update({"d/" + k: v for k, v in C.flatten(dp).items()})
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
    print(f"[torch_moe_ref] {len(C.CASES)} cases on {jax.device_count()} devices "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
