"""Run the port's fault layer in a world of gloo processes.

    python tests/subproc/torch_fault_world.py --out OUT.npz [--store DIR]
    python tests/subproc/torch_fault_world.py --suite full [--time-kb 1024]

Torch only (no jax), so it runs where the card is, too.  It spawns
``WORLD`` (8) ranks, each with one CPU thread, which meet through a
``FileStore`` in ``--store`` (a fresh directory by default; never a TCP
port) with a 60 s timeout, on the mesh [2, 4] of
``tests/subproc/check_fault_tolerance.py``.

``--suite checks`` (the default) runs every case of
``torch_fault_cases.VERIFIED`` through ``execute_plan_verified`` under its
``FaultInjection``, then that script's api sections (the ``verify`` policy's
fallback counting, ``report_fault``, the dead axis, the seeded
``FaultTrace`` loop), and evaluates ``torch_fault_cases.CHECKS`` on every
rank.  A check passes when it passes on all 8 ranks; the script prints
``N/M checks passed`` and, with ``--out``, writes the ranks' outputs,
diagnostics, counters and check verdicts stacked.
``tests/test_torch_fault_exec.py`` holds those to the reference on 8 fake
devices.

``--suite full`` also times ``api.all_gather`` and ``api.all_reduce`` at a
``--time-kb`` shard (values in {-1, 0, 1}, so every checksum is exact) with
``PlanPolicy(verify=True)`` and without, asserts the two bit-identical,
and prints the verified-to-plain ratio (the slowest rank's mean of
``--reps`` calls, host CPU under gloo).
"""
from __future__ import annotations

import argparse
import contextlib
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

import torch_fault_cases as C  # noqa: E402

#: a hung world fails in minutes, not at a test suite's limit
JOIN_TIMEOUT_S = 200


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _world_sum(mesh, value) -> int:
    """``value`` (a bool or int) summed over every rank of the mesh."""
    import torch

    return int(mesh.psum(torch.tensor([int(value)], dtype=torch.int64), C.NAMES))


def _verified_cases(rank, mesh, outs):
    """Every VERIFIED case; returns {id: (out, diag, applied)} of this rank."""
    import torch

    from repro_torch.comms import FaultInjection, api, execute_plan_verified, fault_injection

    got = {}
    for case in C.VERIFIED:
        ctx = api.CommContext(mesh, C.NAMES, policy=api.PlanPolicy(regime=case["regime"]))
        plan = C.plan_for(case, api, ctx)
        x = torch.from_numpy(C.inputs(case["op"])[rank])
        spec = FaultInjection(**case["fault"]) if case["fault"] else None
        with fault_injection(spec) if spec else contextlib.nullcontext():
            out, diag = execute_plan_verified(x, plan, retries=case["retries"], mesh=mesh)
        applied = spec.applied if spec else 0
        cid = case["id"]
        outs[cid] = out.numpy()
        for key, val in diag.items():
            outs[f"{cid}#{key}"] = val.numpy()
        outs[f"{cid}#applied"] = np.array(applied)
        outs[f"{cid}#plan"] = C.plan_row(plan)
        got[cid] = (out, diag, applied)
    return got


def _checks_suite(rank, out_dir):
    """check_fault_tolerance.py's checks, on this rank, plus the
    device-restricted fault's; writes ``rank<r>.npz``."""
    import torch

    from repro_torch.comms import FactorizedMesh, FaultInjection, api, fault_injection
    from repro_torch.core import FaultTrace, LinkHealth
    from repro_torch.core.health import CCW, CW

    mesh = FactorizedMesh(C.FACTORS, C.NAMES)
    names = C.NAMES
    x = torch.arange(64, dtype=torch.float32)
    shard = x[8 * rank:8 * rank + 8]
    outs = {}
    checks = {}

    def check(name, got, want):
        checks[name] = _bits_equal(got, want)

    def expect(name, cond):
        checks[name] = bool(cond)

    # ---- 1. the verified executor detects injected faults -----------------
    got = _verified_cases(rank, mesh, outs)
    out, diag, _ = got["ag-healthy"]
    check("verified ag healthy", out, x)
    expect("healthy: no fallback", _world_sum(mesh, diag["used_fallback"]) == 0)
    expect("healthy: attempt 0 clean", _world_sum(mesh, ~diag["attempt_ok"][0]) == 0)

    out, diag, applied = got["ag-drop-once"]
    check("drop x1: recovered bits", out, x)
    expect("drop x1: detected on all devices",
           _world_sum(mesh, ~diag["attempt_ok"][0]) == C.WORLD)
    expect("drop x1: retry recovered (no fallback)",
           _world_sum(mesh, diag["used_fallback"]) == 0)
    expect("drop x1: injection consumed once", applied == 1)

    out, diag, applied = got["ag-corrupt-forever"]
    check("corrupt forever: fallback bits", out, x)
    expect("corrupt forever: detected", _world_sum(mesh, ~diag["attempt_ok"][0]) == C.WORLD)
    expect("corrupt forever: used fallback on all devices",
           _world_sum(mesh, diag["used_fallback"]) == C.WORLD)
    expect("corrupt forever: both attempts injected", applied == 2)

    out, diag, applied = got["ag-drop-once-device1"]
    expect("device drop: every rank completed", _world_sum(mesh, 1) == C.WORLD)
    check("device drop: bits", out, x)
    bad0 = _world_sum(mesh, ~diag["attempt_ok"][0])
    expect("device drop: ranks disagree on attempt 0", 0 < bad0 < C.WORLD)
    expect("device drop: no fallback", _world_sum(mesh, diag["used_fallback"]) == 0)
    expect("device drop: applied on every rank", _world_sum(mesh, applied == 1) == C.WORLD)

    # ---- 2. api ops under PlanPolicy(verify=True) count fallbacks ---------
    ctx_v = api.CommContext(mesh, names, policy=api.PlanPolicy(verify=True, verify_retries=1))
    with fault_injection(FaultInjection(axis="b", hop=1, mode="drop", times=1)):
        outs["api-drop-once"] = api.all_gather(shard, ctx=ctx_v, mode="perhop")
    check("api verify: drop x1 bits", outs["api-drop-once"], x)
    drop_fallbacks = ctx_v.cache_stats.fallbacks
    expect("api verify: retry not counted as fallback", drop_fallbacks == 0)
    with fault_injection(FaultInjection(axis="b", hop=1, mode="corrupt", times=999)):
        outs["api-corrupt-forever"] = api.all_gather(shard, ctx=ctx_v, mode="perhop")
    check("api verify: corrupt-forever bits", outs["api-corrupt-forever"], x)
    corrupt_fallbacks = ctx_v.cache_stats.fallbacks
    expect("api verify: executor fallback counted", corrupt_fallbacks == 1)
    # the backward of a verified AG is a verified RS: rank r's gradient of
    # sum(gathered * w) is block r of the ranks' summed w
    w = torch.arange(64, dtype=torch.float32)
    leaf = shard.clone().requires_grad_(True)
    (api.all_gather(leaf, ctx=ctx_v, mode="perhop") * w).sum().backward()
    check("api verify: gradient through the dual collective", leaf.grad,
          C.WORLD * w[8 * rank:8 * rank + 8])

    # ---- 3. report_fault -> self-healing cache ----------------------------
    with api.comm_context(mesh, names) as ctx:
        outs["want-ag"] = api.all_gather(shard, ctx=ctx)
        outs["want-ar"] = api.all_reduce(x, axis=0, ctx=ctx)
        n_plans = len(ctx.plans())
        expect("cache primed", n_plans >= 2)
        fp0 = ctx.health_fp
        ctx.report_fault(axis="a", derate=0.5)
        expect("fault changed the health fingerprint", ctx.health_fp != fp0)
        replans = ctx.cache_stats.replans_on_fault
        expect("every cached plan re-planned in place", replans == n_plans)
        misses0 = ctx.cache_stats.misses
        outs["degraded-ag"] = api.all_gather(shard, ctx=ctx)
        outs["degraded-ar"] = api.all_reduce(x, axis=0, ctx=ctx)
        check("degraded ag bits", outs["degraded-ag"], outs["want-ag"])
        check("degraded ar bits", outs["degraded-ar"], outs["want-ar"])
        misses_delta = ctx.cache_stats.misses - misses0
        expect("degraded ops hit the re-planned cache", misses_delta == 0)
        expect("degraded plans stamped with the health fp",
               all(pl.meta.get("health_fp") == ctx.health_fp for pl in ctx.plans()))

    # ---- 4. dead axis -> forced one-shot planning fallback ----------------
    dead = LinkHealth.make(dead=[("a", CW), ("a", CCW)])
    ctx_d = api.CommContext(mesh, names, health=dead)
    outs["dead-ag"] = api.all_gather(shard, ctx=ctx_d)
    check("dead-axis fallback bits", outs["dead-ag"], x)
    plans_d = ctx_d.plans()
    dead_is_fallback = (len(plans_d) == 1 and plans_d[0].is_fallback
                        and plans_d[0].mode == "oneshot")
    expect("dead axis planned as one-shot fallback", dead_is_fallback)
    expect("dead axis counted in CacheStats.fallbacks", ctx_d.cache_stats.fallbacks == 1)

    # ---- 5. seeded FaultTrace over a multi-step loop ----------------------
    trace = FaultTrace.generate(["a", "b"], C.TRACE_STEPS, **C.TRACE)
    expect("trace has events", len(trace.events) > 0)
    expect("trace is deterministic",
           trace == FaultTrace.generate(["a", "b"], C.TRACE_STEPS, **C.TRACE))

    def loop_outputs(ctx, with_faults):
        ags, ars = [], []
        for step in range(C.TRACE_STEPS):
            if with_faults and trace.at(step):
                ctx.update_health(trace.replay(step))
            y = torch.from_numpy(C.trace_input(step))
            ags.append(api.all_gather(y[8 * rank:8 * rank + 8], ctx=ctx))
            ars.append(api.all_reduce(y, axis=0, ctx=ctx))
        return torch.stack(ags), torch.stack(ars)

    with api.comm_context(mesh, names) as ctx_h:
        healthy = loop_outputs(ctx_h, with_faults=False)
    with api.comm_context(mesh, names) as ctx_f:
        outs["trace-ag"], outs["trace-ar"] = loop_outputs(ctx_f, with_faults=True)
        trace_replans = ctx_f.cache_stats.replans_on_fault
        expect("trace loop re-planned on faults", trace_replans > 0)
    expect(f"all {C.TRACE_STEPS} trace-loop steps bit-identical to healthy run",
           _bits_equal(healthy[0], outs["trace-ag"]) and _bits_equal(healthy[1], outs["trace-ar"]))

    stats = dict(verify_drop_fallbacks=drop_fallbacks,
                 verify_corrupt_fallbacks=corrupt_fallbacks, primed_plans=n_plans,
                 replans_on_fault=replans, degraded_misses_delta=misses_delta,
                 dead_plans=len(plans_d), dead_is_fallback=int(dead_is_fallback),
                 dead_fallbacks=ctx_d.cache_stats.fallbacks,
                 trace_events=len(trace.events), trace_replans=trace_replans)
    outs["api#stats"] = np.array([stats[k] for k in C.API_STATS], np.int64)
    missing = set(C.CHECKS) ^ set(checks)
    if missing:
        raise AssertionError(f"checks not evaluated or unknown: {sorted(missing)}")
    outs["checks"] = np.array([checks[n] for n in C.CHECKS])
    outs = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in outs.items()}
    np.savez(out_dir / f"rank{rank}.npz", **outs)


def _time(fn, reps):
    """Mean ms of ``reps`` calls, the slowest rank's (host clock)."""
    import torch
    import torch.distributed as dist

    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = torch.tensor([(time.perf_counter() - t0) / reps * 1e3], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _time_suite(rank, kb, reps):
    """Verified against plain ``all_gather`` and ``all_reduce`` at a ``kb``
    KiB shard: bit-identical, no fallback, both timed."""
    import torch

    from repro_torch.comms import FactorizedMesh, api

    mesh = FactorizedMesh(C.FACTORS, C.NAMES)
    length = kb * 256
    g = torch.Generator().manual_seed(rank)
    for op, fn, shape in (("ag", api.all_gather, (length,)),
                          ("ar", api.all_reduce, (C.WORLD * length,))):
        x = torch.randint(-1, 2, shape, generator=g).float()
        plain = api.CommContext(mesh, C.NAMES)
        verified = api.CommContext(mesh, C.NAMES, policy=api.PlanPolicy(verify=True))
        want, got = fn(x, axis=0, ctx=plain), fn(x, axis=0, ctx=verified)
        if not _bits_equal(got, want):
            raise AssertionError(f"{op}: verified differs from plain on rank {rank}")
        t_plain = _time(lambda: fn(x, axis=0, ctx=plain), reps)
        t_ver = _time(lambda: fn(x, axis=0, ctx=verified), reps)
        falls = _world_sum(mesh, verified.cache_stats.fallbacks)
        (plan,) = verified.plans()
        if rank == 0:
            print(f"[fault/gloo8] mesh [2, 4] {op} {kb} KiB plan {plan.mode} "
                  f"x{plan.num_chunks}: plain {t_plain:.3f} ms, verified {t_ver:.3f} ms, "
                  f"ratio {t_ver / t_plain:.2f}, fallbacks {falls}, bit-identical",
                  flush=True)
        if falls:
            raise AssertionError(f"{op}: a healthy verified run fell back")


def _rank_main(rank, world, store, out_dir, suite, kb, reps):
    """One rank: join the world, run the suite."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.comms import init_world

    init_world("cpu", world_size=world, rank=rank, store_path=store)
    try:
        _checks_suite(rank, Path(out_dir))
        if suite == "full":
            _time_suite(rank, kb, reps)
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
        raise SystemExit(f"torch_fault_world: rank exit codes {codes} "
                         f"(None: killed after {timeout_s} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", choices=("checks", "full"), default="checks")
    ap.add_argument("--out", help="the .npz of outputs, diagnostics and verdicts")
    ap.add_argument("--store", help="a fresh directory for the FileStore")
    ap.add_argument("--time-kb", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=JOIN_TIMEOUT_S)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(dir=args.store) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        spawn_world(C.WORLD, (str(tmp / "store"), str(tmp), args.suite, args.time_kb,
                              args.reps), args.timeout)
        ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(C.WORLD)]
        stacked = {k: np.stack([z[k] for z in ranks]) for k in ranks[0]}
        passed = stacked["checks"].all(axis=0)
        for name, ok in zip(C.CHECKS, passed):
            if not ok:
                print(f"[fault/gloo8] FAIL {name}", flush=True)
        print(f"[fault/gloo8] {int(passed.sum())}/{len(C.CHECKS)} checks passed "
              f"on {C.WORLD} gloo ranks in {time.perf_counter() - t0:.1f} s", flush=True)
        if args.out:
            np.savez(args.out, **stacked)
    return 0


if __name__ == "__main__":
    sys.exit(main())
