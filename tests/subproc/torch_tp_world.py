"""Run the port's tensor-parallel ops and block in a world of gloo processes.

    python tests/subproc/torch_tp_world.py --out OUT.npz [--store DIR]
    python tests/subproc/torch_tp_world.py --suite full [--reps 2]

Torch only (no jax), so it runs where the card is, too.  It spawns
``WORLD`` (8) ranks, each with one CPU thread, which meet through a
``FileStore`` in ``--store`` (a fresh directory by default; never a TCP
port) with a 60 s timeout; every rank builds the meshes of
``torch_tp_cases.MESHES`` in the same order, and a rank that fails exits at
once and the rest are killed.

``--suite cases`` (the default) runs every case of ``torch_tp_cases`` on
this rank's shard (the fused ops ``api.allgather_matmul`` and
``api.matmul_reduce_scatter`` beside the planned collectives they fuse,
their gradients, ``ffn_apply_tp``, ``ffn_apply_tp_sp``'s gradients,
``transformer_block_tp``, ``sharded_decode_attention`` and ZeRO-1) and
writes ``--out``: per case and output, the 8 ranks' arrays stacked.
``tests/test_torch_tp_exec.py`` holds them to the reference on 8 fake
devices and to numpy.

``--suite full`` runs ``transformer_block_tp`` at full granite-3-2b width
(d 2048, 32/8 heads of 64, d_ff 8192, f32, B 1, S 256) on meshes [8] and
[2, 4], TP and SP, with the fused rings forced on, off and ``"auto"``;
holds each rank's output to ``transformer_block_ref`` on the full layer
within ``FULL_RTOL`` of max |ref|, and prints per case the slowest rank's
mean ms per block over ``--reps`` calls against the unsharded block's (host
CPU under gloo, one thread a rank), the plans and collectives one block
issued with their modeled electrical and optical time, and the modes.
"""
from __future__ import annotations

import argparse
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

import torch_tp_cases as C  # noqa: E402

#: a hung world fails in minutes, not at a test suite's limit
JOIN_TIMEOUT_S = 200
#: full width, f32: each rank's output against the full block, relative
#: to max |ref| (the reduction orders of the combines differ)
FULL_RTOL = 1e-4


def _t(a, grad=False):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _layer_tree(layer):
    return {k: _layer_tree(v) if isinstance(v, dict) else _t(v) for k, v in layer.items()}


def _cfg(name):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite-3-2b"), **C.config_fields(name))


def _local_layer(layer, mesh, names, sp, grad=False):
    """This rank's TP slice of the full layer (``shard_tp_layer``)."""
    from repro_torch.models import shard_tp_layer, tp_block_specs

    full = _layer_tree(layer)
    x_split, specs = tp_block_specs(full, sequence_parallel=sp)
    local = shard_tp_layer(full, specs, mesh, names)
    if grad:
        local = _leaves_requiring_grad(local)
    return x_split, local


def _leaves_requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _leaves_requiring_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _grads(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_grads(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v.grad.numpy()
    return out


def _positions(B, S):
    import torch

    return torch.arange(S).expand(B, S)


def run_case(case, mesh, rank):
    """This rank's outputs for ``case``: a dict of numpy arrays."""
    import torch

    from repro_torch.comms import api, sharded_decode_attention
    from repro_torch.models import transformer_block_tp
    from repro_torch.models.mlp import ffn_apply_tp, ffn_apply_tp_sp
    from repro_torch.optim import zero1_shard_grads, zero1_unshard_params

    kind, names = case["kind"], tuple(case["names"])
    inp = C.inputs(case)
    n = mesh.axis_size(names)
    idx = mesh.axis_index(names)
    out = {}
    with api.comm_context(mesh, names, fuse=case["fuse"]) as ctx:
        if kind == "ops":
            x, w0, w1 = (_t(inp[k][rank]) for k in ("x", "w0", "w1"))
            g_single, o_single = api.allgather_matmul(x, w0, axis=1)
            g_pair, (o_pair0, o_pair1) = api.allgather_matmul(x, (w0, w1), axis=1)
            ag = api.all_gather(x, axis=1)
            h, v = _t(inp["h"][rank]), _t(inp["v"][rank])
            out.update(g_single=g_single, o_single=o_single, g_pair=g_pair,
                       o_pair0=o_pair0, o_pair1=o_pair1, ag=ag, unfused0=ag @ w0,
                       unfused1=ag @ w1, y=api.matmul_reduce_scatter(h, v, axis=1),
                       unfused_y=api.reduce_scatter(h @ v, axis=1))
        elif kind == "ops_grad":
            leaves = {k: _t(inp[k][rank], True) for k in ("x", "w0", "w1", "h", "v", "a")}
            g, (o0, o1) = api.allgather_matmul(
                leaves["x"], (leaves["w0"], leaves["w1"]), axis=1)
            y = api.matmul_reduce_scatter(leaves["h"], leaves["v"], axis=1)
            t = api.all_to_all(leaves["a"], axis=0)
            loss = sum((a * _t(inp[c][rank])).sum() for a, c in (
                (g, "cg"), (o0, "c0"), (o1, "c1"), (y, "cy"), (t, "ca")))
            loss.backward()
            out.update({f"d{k}": a.grad for k, a in leaves.items()})
        elif kind in ("ffn_tp", "ffn_tp_grad", "ffn_sp_grad"):
            sp = kind == "ffn_sp_grad"
            _, local = _local_layer(C.layer_of(inp), mesh, names, sp, grad=True)
            p = local["ffn"]
            x = _t(inp["x"])
            if sp:
                S = x.shape[1] // n
                x = x[:, idx * S:(idx + 1) * S]
            x = x.contiguous().clone().requires_grad_(True)
            if sp:
                y = ffn_apply_tp_sp(p, x)
                (y * y).sum().backward()
            else:
                y = ffn_apply_tp(p, x)
                out["y"] = y
                if kind == "ffn_tp_grad":
                    (y * _t(inp["c"][rank])).sum().backward()
            if x.grad is not None:
                out.update(dx=x.grad, **_grads(p, "d"))
        elif kind == "block":
            cfg = _cfg(case["cfg"])
            layer = C.layer_of(inp)
            x_split, local = _local_layer(layer, mesh, names, case["sp"])
            x = _t(inp["x"])
            B, S = x.shape[:2]
            if x_split is not None:  # the kernels take contiguous activations
                x = x.narrow(x_split, idx * (S // n), S // n).contiguous()
            with torch.no_grad():
                y = transformer_block_tp(local, cfg, x, positions=_positions(B, S),
                                         sequence_parallel=case["sp"])
            out["out"] = y
            out["plans"] = np.array(len(ctx.plans()))
        elif kind == "decode":
            k, v = (_t(inp[a]).chunk(n, dim=2)[idx] for a in ("k", "v"))
            for valid in C.DECODE_VALID:
                out[f"out{valid}"] = sharded_decode_attention(
                    _t(inp["q"]), k, v, axis_name=names[0], valid_len=valid)
        elif kind == "zero1":
            g = {"w": _t(inp["g/w"][rank]), "b": _t(inp["g/b"][rank])}
            fast, slow = tuple(case["fast"]), tuple(case["slow"])
            sharded = zero1_shard_grads(g, fast, slow, num_chunks=2)
            full = zero1_unshard_params(sharded, fast, reference=g)
            out.update(scattered_w=sharded["w"], w=full["w"], b=full["b"])
        else:
            raise ValueError(kind)
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _cases_suite(rank, meshes, out_dir):
    outs = {}
    for case in C.CASES:
        for k, v in run_case(case, meshes[case["mesh"]], rank).items():
            outs[f"{case['id']}#{k}"] = v
    np.savez(out_dir / f"rank{rank}.npz", **outs)


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


def _full_suite(rank, meshes, reps):
    """Full-width granite-3-2b blocks against the full layer's block."""
    import torch
    import torch.distributed as dist

    import dataclasses

    from repro_torch.comms import api
    from repro_torch.core.cost_model import TERARACK, price
    from repro_torch.models import transformer_block_ref, transformer_block_tp

    cfg = _cfg("granite_full")
    cases = C.full_cases()
    inp = C.inputs(cases[0])  # one layer and input for every case
    layer, full = C.layer_of(inp), _layer_tree(C.layer_of(inp))
    x_full = _t(inp["x"])
    B, S = x_full.shape[:2]
    pos = _positions(B, S)
    with torch.no_grad():
        ref = transformer_block_ref(full, cfg, x_full, positions=pos)
        ref_ms = _time(lambda: transformer_block_ref(full, cfg, x_full, positions=pos), 1)
    ref_max = float(ref.abs().max())
    for case in cases:
        mesh, names = meshes[case["mesh"]], tuple(case["names"])
        n, idx = mesh.axis_size(names), mesh.axis_index(names)
        x_split, local = _local_layer(layer, mesh, names, case["sp"])
        x, want = x_full, ref
        if x_split is not None:
            x = x_full.narrow(x_split, idx * (S // n), S // n).contiguous()
            want = ref.narrow(x_split, idx * (S // n), S // n)
        with api.comm_context(mesh, names, fuse=case["fuse"]) as ctx, torch.no_grad():
            def block():
                return transformer_block_tp(local, cfg, x, positions=pos,
                                            sequence_parallel=case["sp"])
            got = block()
            usage = ctx.plan_usage()  # what one block planned and issued
            err = float((got - want).abs().max()) / ref_max
            if not (err <= FULL_RTOL and got.shape == want.shape):
                raise AssertionError(f"{case['id']}: rank {rank} off the full block by "
                                     f"{err:.2e} of max |ref| (limit {FULL_RTOL})")
            ms = _time(block, reps)
        worst = torch.tensor([err], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        if rank == 0:
            # the plans one block issued, priced electrical (the planner's
            # default links) and optical, weighted by issue count
            elec = sum(price(p).total_s * c for p, c in usage) * 1e6
            opt = sum(price(p, dataclasses.replace(TERARACK, n_nodes=p.n)).total_s * c
                      for p, c in usage) * 1e6
            print(f"[tp/gloo8] {case['id']} mesh {list(mesh.factors)} B {B} S {S} "
                  f"d {cfg.d_model}: {ms:.1f} ms per block (unsharded block "
                  f"{ref_ms:.1f} ms on one rank) plans {len(usage)} issued "
                  f"{sum(c for _, c in usage)} modeled elec {elec:.1f} us optical "
                  f"{opt:.1f} us modes {sorted({p.mode for p, _ in usage})} "
                  f"max_err/max|ref| {float(worst):.2e} (limit {FULL_RTOL}) ok", flush=True)
        dist.barrier()


def _rank_main(rank, world, store, out_dir, suite, reps):
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
            _full_suite(rank, meshes, reps)
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
        raise SystemExit(f"torch_tp_world: rank exit codes {codes} "
                         f"(None: killed after {timeout_s} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", choices=("cases", "full"), default="cases")
    ap.add_argument("--out", help="the .npz the cases suite writes")
    ap.add_argument("--store", help="a fresh directory for the FileStore")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=JOIN_TIMEOUT_S)
    args = ap.parse_args(argv)
    if args.suite == "cases" and not args.out:
        ap.error("--suite cases needs --out")
    with tempfile.TemporaryDirectory(dir=args.store) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        spawn_world(C.WORLD, (str(tmp / "store"), str(tmp), args.suite, args.reps),
                    args.timeout)
        if args.suite == "cases":
            ranks = [np.load(tmp / f"rank{r}.npz") for r in range(C.WORLD)]
            np.savez(args.out, **{k: np.stack([z[k] for z in ranks])
                                  for k in ranks[0].files})
        print(f"[torch_tp_world] {args.suite}: {C.WORLD} gloo ranks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
