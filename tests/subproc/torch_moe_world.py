"""Run the port's expert-parallel MoE block in a world of gloo processes.

    python tests/subproc/torch_moe_world.py --out OUT.npz [--store DIR]
    python tests/subproc/torch_moe_world.py --suite full [--reps 2]

Torch only (no jax), so it runs where the card is, too.  It spawns
``WORLD`` (8) ranks, each with one CPU thread, which meet through a
``FileStore`` in ``--store`` (a fresh directory by default; never a TCP
port) with a 60 s timeout; every rank builds the meshes of
``torch_moe_cases.MESHES`` in the same order, and a rank that fails exits
at once and the rest are killed.

``--suite cases`` (the default) runs every case of ``torch_moe_cases`` on
this rank's batch rows: ``moe_block`` of ``expert_parallel(cfg, axis)``
under a ``comm_context`` of the mesh's axes (its output, aux losses and the
plans the context issued), the one-device block on the same rows, and the
gradients of ``sum(out * c_r) + load_balance + router_z``.  It writes
``--out``: per case and output, the 8 ranks' arrays stacked.
``tests/test_torch_moe_exec.py`` holds them to the reference on 8 fake
devices.

``--suite full`` runs llama4-scout-17b-a16e's MoE block at full width (d
5120, 16 experts of d_ff 8192, top-1, a shared expert; f32, B 1, S 64 a
rank) on the mesh [8] with the experts on it, 2 a rank: each rank holds
only its own experts (an (E/8)-leading local shard), drawn expert by
expert from seeded generators, so rank 0 can draw all 16 for the
one-device block.  Rank 0 runs the one-device block on every rank's rows
(8 threads while the others wait), each rank's expert-parallel output is
held within ``FULL_RTOL`` of max |ref|, and the suite prints the slowest
rank's ms per block over ``--reps`` calls, the a2a plans and issues, and
the aux losses.  ``--reduced`` runs the same suite at d 64, d_ff 128.
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

import torch_moe_cases as C  # noqa: E402

#: a hung world fails in minutes, not at a test suite's limit
JOIN_TIMEOUT_S = 200
#: full width, f32: each rank's output against the one-device block,
#: relative to max |ref|
FULL_RTOL = 1e-5


def _t(a, grad=False):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _tree(tree, grad=False):
    return {k: _tree(v, grad) if isinstance(v, dict) else _t(v, grad) for k, v in tree.items()}


def _grads(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_grads(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v.grad.numpy()
    return out


def _cfg():
    from repro_torch.configs import ModelConfig, MoEConfig

    return ModelConfig(**C.CONFIG, moe=MoEConfig(**C.MOE))


def run_case(case, mesh, rank):
    """This rank's outputs for ``case``: a dict of numpy arrays."""
    import torch

    from repro_torch.comms import api
    from repro_torch.configs import expert_parallel
    from repro_torch.models.moe import moe_block

    cfg = _cfg()
    ep_cfg = expert_parallel(cfg, axis=case["axis"])
    inp = C.inputs(case)
    b = inp["x"].shape[0] // C.WORLD
    grad = case["kind"] == "grad"
    p = _tree(C.params_of(inp), grad)
    x = _t(inp["x"][rank * b:(rank + 1) * b], grad)
    names = mesh.axis_names
    out = {}
    with api.comm_context(mesh, names) as ctx:
        y, aux = moe_block(p, ep_cfg, x)
        if grad:
            loss = (y * _t(inp["c"][rank])).sum() + aux["load_balance"] + aux["router_z"]
            loss.backward()
            out["dx"] = x.grad
            out.update(_grads(p, "d"))
        else:
            out.update(out=y, lb=aux["load_balance"], rz=aux["router_z"],
                       plans=C.plan_summary(ctx.plans()))
            with torch.no_grad():
                out["local"] = moe_block(p, cfg, x)[0]
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _cases_suite(rank, meshes, out_dir):
    outs = {}
    for case in C.CASES:
        for k, v in run_case(case, meshes[case["mesh"]], rank).items():
            outs[f"{case['id']}#{k}"] = v
    np.savez(out_dir / f"rank{rank}.npz", **outs)


def _full_cfg(reduced):
    from repro_torch.configs import expert_parallel, get_config

    cfg = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    if reduced:
        cfg = dataclasses.replace(cfg, d_model=64, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=128))
    return cfg, expert_parallel(cfg, axis="ep")


def _expert(cfg, e):
    """Expert ``e``'s gate, up and down, drawn from its own seeded
    generator at 1/sqrt(fan-in)."""
    import torch

    d, f = cfg.d_model, cfg.moe.d_ff_expert
    g = torch.Generator().manual_seed(1000 + e)
    return (torch.randn((d, f), generator=g) / d ** 0.5,
            torch.randn((d, f), generator=g) / d ** 0.5,
            torch.randn((f, d), generator=g) / f ** 0.5)


def _full_params(cfg, experts):
    import torch

    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    g = torch.Generator().manual_seed(7)
    drawn = [_expert(cfg, e) for e in experts]
    return {"router": {"w": torch.randn((d, E), generator=g) / d ** 0.5},
            "experts": {k: torch.stack([w[i] for w in drawn])
                        for i, k in enumerate(("gate", "up", "down"))},
            "shared": {"gate": {"w": torch.randn((d, f), generator=g) / d ** 0.5},
                       "up": {"w": torch.randn((d, f), generator=g) / d ** 0.5},
                       "down": {"w": torch.randn((f, d), generator=g) / f ** 0.5}}}


def _time(fn, reps):
    """Mean ms of ``reps`` calls after one warm-up, the slowest rank's
    (host clock; gloo calls return when the data is in place)."""
    import torch
    import torch.distributed as dist

    fn()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = torch.tensor([(time.perf_counter() - t0) / reps * 1e3], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _full_suite(rank, reps, reduced):
    """llama4-scout's MoE block at full width, experts over the mesh [8]."""
    import torch
    import torch.distributed as dist

    from repro_torch.comms import FactorizedMesh, api
    from repro_torch.models.moe import moe_block

    cfg, ep_cfg = _full_cfg(reduced)
    E, d = cfg.moe.num_experts, cfg.d_model
    mesh = FactorizedMesh([C.WORLD], ("ep",))
    e_loc = E // C.WORLD
    B, S = C.FULL["B"], C.FULL["S"]
    xs = torch.randn((C.WORLD, B, S, d), generator=torch.Generator().manual_seed(11))
    t0 = time.perf_counter()
    ref = torch.empty((C.WORLD, B, S, d))
    if rank == 0:  # the one-device block on every rank's rows, all experts
        full = _full_params(cfg, range(E))
        torch.set_num_threads(C.WORLD)
        with torch.no_grad():
            for r in range(C.WORLD):
                ref[r] = moe_block(full, cfg, xs[r])[0]
        torch.set_num_threads(1)
        del full
    ref_s = time.perf_counter() - t0
    dist.broadcast(ref, src=0)
    local = _full_params(cfg, range(rank * e_loc, (rank + 1) * e_loc))
    with api.comm_context(mesh, ("ep",)) as ctx, torch.no_grad():
        def block():
            return moe_block(local, ep_cfg, xs[rank])
        got, aux = block()
        usage = ctx.plan_usage()
        err = float((got - ref[rank]).abs().max()) / float(ref[rank].abs().max())
        ms = _time(block, reps)
    worst = torch.tensor([err], dtype=torch.float64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    if not err <= FULL_RTOL:
        raise AssertionError(f"rank {rank} off the one-device block by {err:.2e} of "
                             f"max |ref| (limit {FULL_RTOL})")
    if rank == 0:
        plans = sorted({f"{p.collective}:{p.mode}" for p, _ in usage})
        print(f"[moe/gloo8] {cfg.name} MoE block d {d} E {E} top-{cfg.moe.top_k} "
              f"d_ff {cfg.moe.d_ff_expert} f32, {e_loc} experts a rank on mesh [8], "
              f"B {B} S {S} a rank: {ms:.1f} ms per block (slowest rank, {reps} calls); "
              f"one-device blocks on rank 0 in {ref_s:.1f} s; plans {plans} issued "
              f"{sum(c for _, c in usage)}; load_balance {float(aux['load_balance']):.6f} "
              f"router_z {float(aux['router_z']):.6f}; max_err/max|ref| {float(worst):.2e} "
              f"(limit {FULL_RTOL}) ok", flush=True)


def _rank_main(rank, world, store, out_dir, suite, reps, reduced):
    """One rank: join the world, build the meshes, run the suite."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.comms import FactorizedMesh, init_world

    init_world("cpu", world_size=world, rank=rank, store_path=store)
    try:
        if suite == "cases":
            meshes = {key: FactorizedMesh(f, n) for key, (f, n) in C.MESHES.items()}
            _cases_suite(rank, meshes, Path(out_dir))
        else:
            _full_suite(rank, reps, reduced)
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
        raise SystemExit(f"torch_moe_world: rank exit codes {codes} "
                         f"(None: killed after {timeout_s} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", choices=("cases", "full"), default="cases")
    ap.add_argument("--out", help="the .npz the cases suite writes")
    ap.add_argument("--store", help="a fresh directory for the FileStore")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the full suite at d 64, d_ff 128")
    ap.add_argument("--timeout", type=float, default=JOIN_TIMEOUT_S)
    args = ap.parse_args(argv)
    if args.suite == "cases" and not args.out:
        ap.error("--suite cases needs --out")
    with tempfile.TemporaryDirectory(dir=args.store) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        spawn_world(C.WORLD, (str(tmp / "store"), str(tmp), args.suite, args.reps,
                              args.reduced), args.timeout)
        if args.suite == "cases":
            ranks = [np.load(tmp / f"rank{r}.npz") for r in range(C.WORLD)]
            np.savez(args.out, **{k: np.stack([z[k] for z in ranks])
                                  for k in ranks[0].files})
        print(f"[torch_moe_world] {args.suite}: {C.WORLD} gloo ranks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
