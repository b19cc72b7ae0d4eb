"""Run the reference's (JAX) executors on the cases of ``torch_comms_cases``.

    python tests/subproc/torch_comms_ref.py --out OUT.npz

Forces 8 fake CPU devices before jax is imported, builds each case's mesh
with ``repro.comms.make_factorized_mesh`` (asserting that its devices are
0..7 in flat order, so device i holds rank i's shard), and runs the case
inside ``shard_map`` on every device's local shard: the ``repro.comms.api``
op under a ``CommContext`` with the case's policy, or the
``repro.comms.collectives`` baseline.  Writes one array per case id, the 8
devices' outputs stacked.  ``tests/test_torch_comms_exec.py`` compares them
with the port's world.
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
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_comms_cases as C  # noqa: E402
from repro import core  # noqa: E402
from repro.comms import api, collectives, make_factorized_mesh  # noqa: E402
from repro.compat import shard_map  # noqa: E402


def _context(case, mesh):
    links = None
    if case.get("links") == "asym":
        links = {a: core.LinkSpec(*spec) for a, spec in C.ASYM.items()}
    kw = {}
    if case.get("order") is not None:
        kw["order"] = case["order"]
        if case["order"] in ("electrical", "optical"):
            kw["optical"] = dataclasses.replace(
                core.TERARACK, n_nodes=C.WORLD, wavelengths=C.OPTICAL_W)
    if case.get("regime"):
        kw["regime"] = case["regime"]
    names = tuple(case.get("names") or mesh.axis_names)
    return api.CommContext(mesh, names, links=links, policy=api.PlanPolicy(**kw))


def run_case(case, mesh):
    op, axis = case["op"], case["axis"]
    if op in C.COLLS:
        ctx = _context(case, mesh)
        fn = {"ag": api.all_gather, "rs": api.reduce_scatter,
              "ar": api.all_reduce, "a2a": api.all_to_all}[op]

        def local(y):
            return fn(y, axis=axis, ctx=ctx, mode=case.get("mode"),
                      num_chunks=case.get("chunks"))
    elif op in ("engine", "tp_all_reduce"):
        import warnings

        import repro.comms as comms

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = comms.StagedCollectiveEngine(mesh, mesh.axis_names)

        def local(y):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                if op == "engine":
                    fn = {"ag": eng.all_gather, "rs": eng.reduce_scatter,
                          "ar": eng.all_reduce}[case["kind"]]
                    return fn(y, axis=axis)
                with api.comm_context(mesh, mesh.axis_names):
                    return comms.tp_all_reduce(y, mesh.axis_names, axis=axis)
    elif op == "exec":
        import repro.comms as comms

        fn = getattr(comms, case["fn"])

        def local(y):
            return fn(y, mesh.axis_names, axis=axis, **case["kwargs"])
    else:
        fn = getattr(collectives, op)
        args = case.get("args", ())
        if op == "hierarchical_all_reduce":
            def local(y):
                return fn(y, *args, gather=case["gather"])
        else:
            def local(y):
                return fn(y, *args, axis=axis)

    spec = P(tuple(mesh.axis_names))
    body = shard_map(lambda y: local(y[0])[None], mesh=mesh, in_specs=spec,
                     out_specs=spec)
    return np.asarray(jax.jit(body)(C.inputs(case)))


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
    outs = {case["id"]: run_case(case, meshes[case["mesh"]]) for case in C.CASES}
    np.savez(args.out, **outs)
    print(f"[torch_comms_ref] {len(outs)} cases on {jax.device_count()} devices "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
