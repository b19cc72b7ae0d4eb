"""Run the reference's (JAX) fault layer on the cases of ``torch_fault_cases``.

    python tests/subproc/torch_fault_ref.py --out OUT.npz

Forces 8 fake CPU devices before jax is imported, builds the mesh [2, 4]
with ``repro.comms.make_factorized_mesh`` (asserting that its devices are
0..7 in flat order, so device i holds rank i's shard), and runs each
``VERIFIED`` case's ``execute_plan_verified`` inside ``shard_map`` under its
``FaultInjection``, then ``tests/subproc/check_fault_tolerance.py``'s api
sections as that script runs them (global arrays, so the verified ops
count their fallbacks).  Writes the same keys as ``torch_fault_world.py``:
per device the outputs and diagnostics stacked, the injection's
``applied`` count, the plan, the api outputs and counters.
``tests/test_torch_fault_exec.py`` compares the two.
"""
from __future__ import annotations

import argparse
import contextlib
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
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import torch_fault_cases as C  # noqa: E402
from repro.comms import api, make_factorized_mesh  # noqa: E402
from repro.comms.plan_executor import execute_plan_verified  # noqa: E402
from repro.comms.ring_executor import FaultInjection, fault_injection  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.core import FaultTrace, LinkHealth  # noqa: E402
from repro.core.health import CCW, CW  # noqa: E402


def _per_device(a) -> np.ndarray:
    """A replicated global result as the 8 devices' stacked copies."""
    a = np.asarray(a)
    return np.broadcast_to(a, (C.WORLD,) + a.shape).copy()


def verified_cases(mesh, outs):
    spec = P(C.NAMES)
    for case in C.VERIFIED:
        ctx = api.CommContext(mesh, C.NAMES, policy=api.PlanPolicy(regime=case["regime"]))
        plan = C.plan_for(case, api, ctx)

        def fn(y, plan=plan, retries=case["retries"]):
            out, diag = execute_plan_verified(y[0], plan, retries=retries)
            return {"out": out[None], **{k: v[None] for k, v in diag.items()}}

        inj = FaultInjection(**case["fault"]) if case["fault"] else None
        with fault_injection(inj) if inj else contextlib.nullcontext():
            res = jax.jit(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec))(
                jnp.asarray(C.inputs(case["op"])))
        cid = case["id"]
        outs[cid] = np.asarray(res.pop("out"))
        for key, val in res.items():
            outs[f"{cid}#{key}"] = np.asarray(val)
        outs[f"{cid}#applied"] = np.full(C.WORLD, inj.applied if inj else 0)
        outs[f"{cid}#plan"] = np.stack([C.plan_row(plan)] * C.WORLD)


def _jit(op, arg, **kw):
    """``op(arg, **kw)`` traced once under ``jax.jit``: the plan cache sees
    one call, as in an eager call, and the program runs compiled."""
    return jax.jit(lambda v: op(v, **kw))(arg)


def api_sections(mesh, outs):
    """check_fault_tolerance.py's sections 2 to 5, as it runs them.  The
    verify section runs eagerly, as a fallback is counted only from a
    concrete flag; the rest run compiled (``_jit``)."""
    names = C.NAMES
    x = jnp.arange(64, dtype=jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P(names)))

    ctx_v = api.CommContext(mesh, names, policy=api.PlanPolicy(verify=True, verify_retries=1))
    with fault_injection(FaultInjection(axis="b", hop=1, mode="drop", times=1)):
        outs["api-drop-once"] = _per_device(api.all_gather(xs, ctx=ctx_v, mode="perhop"))
    drop_fallbacks = ctx_v.cache_stats.fallbacks
    with fault_injection(FaultInjection(axis="b", hop=1, mode="corrupt", times=999)):
        outs["api-corrupt-forever"] = _per_device(
            api.all_gather(xs, ctx=ctx_v, mode="perhop"))
    corrupt_fallbacks = ctx_v.cache_stats.fallbacks

    with api.comm_context(mesh, names) as ctx:
        outs["want-ag"] = _per_device(_jit(api.all_gather, xs, ctx=ctx))
        outs["want-ar"] = _per_device(_jit(api.all_reduce, x, axis=0, ctx=ctx))
        n_plans = len(ctx.plans())
        ctx.report_fault(axis="a", derate=0.5)
        replans = ctx.cache_stats.replans_on_fault
        misses0 = ctx.cache_stats.misses
        outs["degraded-ag"] = _per_device(_jit(api.all_gather, xs, ctx=ctx))
        outs["degraded-ar"] = _per_device(_jit(api.all_reduce, x, axis=0, ctx=ctx))
        misses_delta = ctx.cache_stats.misses - misses0

    dead = LinkHealth.make(dead=[("a", CW), ("a", CCW)])
    ctx_d = api.CommContext(mesh, names, health=dead)
    outs["dead-ag"] = _per_device(_jit(api.all_gather, xs, ctx=ctx_d))
    plans_d = ctx_d.plans()
    dead_is_fallback = (len(plans_d) == 1 and plans_d[0].is_fallback
                        and plans_d[0].mode == "oneshot")

    trace = FaultTrace.generate(["a", "b"], C.TRACE_STEPS, **C.TRACE)
    with api.comm_context(mesh, names) as ctx_f:
        ags, ars = [], []
        for step in range(C.TRACE_STEPS):
            if trace.at(step):
                ctx_f.update_health(trace.replay(step))
            y = jnp.asarray(C.trace_input(step))
            ys = jax.device_put(y, NamedSharding(mesh, P(names)))
            ags.append(np.asarray(_jit(api.all_gather, ys, ctx=ctx_f)))
            ars.append(np.asarray(_jit(api.all_reduce, y, axis=0, ctx=ctx_f)))
        trace_replans = ctx_f.cache_stats.replans_on_fault
    outs["trace-ag"] = _per_device(np.stack(ags))
    outs["trace-ar"] = _per_device(np.stack(ars))

    stats = dict(verify_drop_fallbacks=drop_fallbacks,
                 verify_corrupt_fallbacks=corrupt_fallbacks, primed_plans=n_plans,
                 replans_on_fault=replans, degraded_misses_delta=misses_delta,
                 dead_plans=len(plans_d), dead_is_fallback=int(dead_is_fallback),
                 dead_fallbacks=ctx_d.cache_stats.fallbacks,
                 trace_events=len(trace.events), trace_replans=trace_replans)
    outs["api#stats"] = _per_device(np.array([stats[k] for k in C.API_STATS], np.int64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mesh = make_factorized_mesh(list(C.FACTORS), list(C.NAMES))
    ids = [d.id for d in mesh.devices.flat]
    if ids != list(range(C.WORLD)):
        raise SystemExit(f"device ids {ids}, want 0..7 in flat order")
    outs = {}
    verified_cases(mesh, outs)
    api_sections(mesh, outs)
    np.savez(args.out, **outs)
    print(f"[torch_fault_ref] {len(C.VERIFIED)} verified cases and the api sections on "
          f"{jax.device_count()} devices in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
