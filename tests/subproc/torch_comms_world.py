"""Run the port's collective executors in a world of gloo processes.

    python tests/subproc/torch_comms_world.py --out OUT.npz [--store DIR]
    python tests/subproc/torch_comms_world.py --suite sizes [--sizes-kb 64,1024,4096]

Torch only (no jax), so it runs where the card is, too.  It spawns
``WORLD`` (8) ranks, each with one CPU thread, which meet through a
``FileStore`` in ``--store`` (a fresh directory by default; never a TCP
port) with a 60 s timeout.  Every rank builds the meshes of
``torch_comms_cases.MESHES`` in the same order.

``--suite cases`` (the default) runs every case of ``torch_comms_cases``
through the port's ``api`` ops and ``collectives.py`` baselines, asserts
each result equal bit for bit to the flat one-shot ``torch.distributed``
collective, and writes ``--out``: one array per case id, the 8 ranks'
outputs stacked, and under ``<id>#plan`` the plan an api op executed.
``tests/test_torch_comms_exec.py`` holds those to the reference's
executors and to numpy.

``--suite sizes`` runs every collective (ag, rs, ar, a2a) in every mode
(oneshot, chunked, perhop, hybrid, and the latency exchange for ag, rs and
ar) on meshes [2, 4] and [2, 2, 2] at each ``--sizes-kb`` shard (the
scattered end; the a2a buffer), asserts bit equality with the flat
collective and prints the mean time of ``--reps`` calls (the slowest
rank's), host CPU under gloo.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch_comms_cases as C  # noqa: E402

#: a hung world fails in minutes, not at a test suite's limit
JOIN_TIMEOUT_S = 200


def _context(case, mesh, api, core):
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


def run_case(case, mesh, x):
    """The port's output for ``case`` on this rank's input ``x``, and the
    flat one-shot collective's."""
    from repro_torch import core
    from repro_torch.comms import api, collectives

    op, axis = case["op"], case["axis"]
    if op in C.COLLS:
        ctx = _context(case, mesh, api, core)
        fn = {"ag": api.all_gather, "rs": api.reduce_scatter,
              "ar": api.all_reduce, "a2a": api.all_to_all}[op]
        out = fn(x, axis=axis, ctx=ctx, mode=case.get("mode"),
                 num_chunks=case.get("chunks"))
        return out, flat(op, x, mesh, ctx.axis_names, axis)
    if op in ("engine", "tp_all_reduce"):
        import warnings

        import repro_torch.comms as comms

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            if op == "engine":
                eng = comms.StagedCollectiveEngine(mesh, mesh.axis_names)
                fn = {"ag": eng.all_gather, "rs": eng.reduce_scatter,
                      "ar": eng.all_reduce}[case["kind"]]
                out = fn(x, axis=axis)
            else:
                with api.comm_context(mesh, mesh.axis_names):
                    out = comms.tp_all_reduce(x, mesh.axis_names, axis=axis)
        return out, flat(case["kind"], x, mesh, mesh.axis_names, axis)
    if op == "exec":
        import repro_torch.comms as comms

        out = getattr(comms, case["fn"])(x, mesh.axis_names, axis=axis, mesh=mesh,
                                         **case["kwargs"])
        return out, flat(case["kind"], x, mesh, mesh.axis_names, axis)
    fn = getattr(collectives, op)
    args = case.get("args", ())
    if op == "hierarchical_all_reduce":
        fast, slow = args
        out = fn(x, fast, slow, gather=case["gather"], mesh=mesh)
        if case["gather"]:
            return out, mesh.psum(x, tuple(fast) + tuple(slow))
        # the fast group's block of the whole sum
        summed = mesh.psum(x, tuple(slow)) if slow else x
        return out, flat("rs", summed, mesh, fast, 0)
    out = fn(x, *args, axis=axis, mesh=mesh)
    if op == "reduce_scatter":
        return out, flat("rs", x, mesh, args, axis)
    return out, flat("ag", x, mesh, args[0], axis)


def flat(op, x, mesh, names, axis):
    """The flat one-shot collective over the group of ``names``."""
    import torch

    names = (names,) if isinstance(names, str) else tuple(names)
    if op == "ag":
        g = mesh.all_gather(x, names)
        g = torch.movedim(g, 0, axis)
        s = tuple(g.shape)
        return g.reshape(s[:axis] + (s[axis] * s[axis + 1],) + s[axis + 2:])
    if op == "rs":
        return torch.movedim(mesh.psum_scatter(torch.movedim(x, axis, 0), names), 0, axis)
    if op == "ar":
        return mesh.psum(x, names)
    return mesh.all_to_all(x, names, axis)


def _same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _spy_executed_plans():
    """A list that collects every plan ``api`` ops execute from now on."""
    from repro_torch.comms import api

    executed = []
    run_local = api._run_local

    def spy(ctx, y, plan, axis):
        executed.append(plan)
        return run_local(ctx, y, plan, axis)

    api._run_local = spy
    return executed


def _cases_suite(rank, meshes, out_dir):
    """Every case; also records, under ``<id>#plan``, the plan each api op
    executed: its mode, chunk count and stage modes."""
    import torch

    executed = _spy_executed_plans()
    outs = {}
    for case in C.CASES:
        executed.clear()
        x = torch.from_numpy(C.inputs(case)[rank])
        got, ref = run_case(case, meshes[case["mesh"]], x)
        if not _same_bits(got, ref):
            raise AssertionError(f"{case['id']}: rank {rank} differs from the flat collective")
        outs[case["id"]] = got.numpy()
        if executed:
            (plan,) = executed
            outs[case["id"] + "#plan"] = np.array(
                [plan.mode, str(plan.num_chunks)] + list(plan.stage_modes))
    np.savez(out_dir / f"rank{rank}.npz", **outs)


#: (mode, chunks) of the sizes suite: chunk counts forced so that every
#: mode runs as named at every size
SIZE_MODES = (("oneshot", None), ("chunked", 4), ("perhop", None), ("hybrid", 2),
              ("latency", None))


def _sizes_suite(rank, meshes, sizes_kb, reps):
    import torch
    import torch.distributed as dist
    from repro_torch.comms import api

    ops = {"ag": api.all_gather, "rs": api.reduce_scatter, "ar": api.all_reduce,
           "a2a": api.all_to_all}
    executed = _spy_executed_plans()
    for key in ("2x4", "2x2x2"):
        mesh = meshes[key]
        names = mesh.axis_names
        for kb in sizes_kb:
            length = kb * 256  # f32 at the scattered end
            for op in C.COLLS:
                shape = C._shape(op, mesh.size, length)
                g = torch.Generator().manual_seed(1000 * kb + rank)
                x = torch.randint(-64, 64, shape, generator=g).float()
                ref = flat(op, x, mesh, names, 0)
                t_flat = _time(lambda: flat(op, x, mesh, names, 0), reps)
                for mode, chunks in SIZE_MODES:
                    if mode == "latency" and op == "a2a":
                        continue  # the latency regime has no a2a plans
                    if mode == "latency":
                        ctx = api.CommContext(mesh, names,
                                              policy=api.PlanPolicy(regime="latency"))
                        fn = (lambda op=op, ctx=ctx: ops[op](x, axis=0, ctx=ctx))
                    else:
                        ctx = api.CommContext(mesh, names)
                        fn = (lambda op=op, ctx=ctx, mode=mode, chunks=chunks:
                              ops[op](x, axis=0, ctx=ctx, mode=mode, num_chunks=chunks))
                    executed.clear()
                    out = fn()
                    plan = executed[-1]
                    if not _same_bits(out, ref):
                        raise AssertionError(
                            f"{key} {op} {kb} KiB {mode}: rank {rank} differs "
                            f"from the flat collective")
                    ms = _time(fn, reps)
                    if rank == 0:
                        print(f"[comms/gloo8] mesh {list(mesh.factors)} {op} {kb} KiB "
                              f"{mode:<8} {ms:9.3f} ms (flat {t_flat:8.3f} ms) "
                              f"executed {plan.mode} x{plan.num_chunks} "
                              f"stages {','.join(plan.stage_modes)} "
                              f"order {','.join(str(a) for a in plan.axes)} "
                              f"bit-identical", flush=True)
                del x, ref
            dist.barrier()


def _time(fn, reps):
    """Mean ms of ``reps`` calls, the slowest rank's (host clock; gloo
    calls return when the data is in place)."""
    import torch
    import torch.distributed as dist

    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = torch.tensor([(time.perf_counter() - t0) / reps * 1e3], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _rank_main(rank, world, store, out_dir, suite, sizes_kb, reps):
    """One rank: join the world, build the meshes, run the suite."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=world, rank=rank, store_path=store)
    try:
        meshes = {key: FactorizedMesh(f, n) for key, (f, n) in C.MESHES.items()}
        if suite == "cases":
            _cases_suite(rank, meshes, Path(out_dir))
        else:
            _sizes_suite(rank, meshes, sizes_kb, reps)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # do not wait on peers that will never answer
    dist.destroy_process_group()


def spawn_world(world, target_args, timeout_s=JOIN_TIMEOUT_S):
    """Start ``world`` ranks, wait at most ``timeout_s`` for all of them and
    kill whatever is left; raise unless every rank exited 0."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world) + target_args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.exitcode not in (None, 0):
                break  # one rank failed: its peers will hang or fail
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise SystemExit(f"torch_comms_world: rank exit codes {codes} "
                         f"(None: killed after {timeout_s} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", choices=("cases", "sizes"), default="cases")
    ap.add_argument("--out", help="the .npz the cases suite writes")
    ap.add_argument("--store", help="a fresh directory for the FileStore")
    ap.add_argument("--sizes-kb", default="64,1024,4096")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=JOIN_TIMEOUT_S)
    args = ap.parse_args(argv)
    if args.suite == "cases" and not args.out:
        ap.error("--suite cases needs --out")
    sizes = tuple(int(s) for s in args.sizes_kb.split(","))
    with tempfile.TemporaryDirectory(dir=args.store) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        spawn_world(C.WORLD, (str(tmp / "store"), str(tmp), args.suite, sizes,
                              args.reps), args.timeout)
        if args.suite == "cases":
            ranks = [np.load(tmp / f"rank{r}.npz") for r in range(C.WORLD)]
            np.savez(args.out, **{cid: np.stack([z[cid] for z in ranks])
                                  for cid in ranks[0].files})
        print(f"[torch_comms_world] {args.suite}: {C.WORLD} gloo ranks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
