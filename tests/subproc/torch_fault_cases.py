"""The fault-layer cases the port's 8-rank world and the reference's 8 fake
devices both run, and the checks the world asserts.

Numpy and the standard library only: ``torch_fault_world.py`` (torch),
``torch_fault_ref.py`` (jax) and ``tests/test_torch_fault_exec.py`` import
it.  The mesh is ``tests/subproc/check_fault_tolerance.py``'s: factors
[2, 4], axes ("a", "b"), rank r at coordinates ``divmod(r, 4)``.

``VERIFIED`` are direct calls of ``execute_plan_verified`` under a
``FaultInjection`` (or none).  A case is a dict:

* ``op``: the collective; ``mode``/``chunks``: the overrides applied to the
  planned plan (``api._apply_overrides``); ``regime``: the plan family;
* ``fault``: the ``FaultInjection`` fields, or None for a healthy run;
* ``retries``: the verified executor's retry budget.

Each side writes, per case id, the 8 ranks' outputs stacked, and under
``<id>#attempt_ok``, ``#used_fallback``, ``#stage_ok`` (per-hop and
exchange paths only), ``#applied`` and ``#plan`` the diagnostics, the
injection's ``applied`` count after the call, and the plan it ran.

The api sections (``API``) are ``check_fault_tolerance.py``'s sections 2 to
5: the ``verify`` policy's fallback counting, ``report_fault``'s in-place
re-plan, the dead-axis one-shot and the seeded 16-step ``FaultTrace``
loop; their outputs and counters are written under their own keys.

Inputs are integer-valued float32 (sums below 2**24), so every checksum
and every sum is exact in any order.
"""
from __future__ import annotations

import numpy as np

WORLD = 8
FACTORS = (2, 4)
NAMES = ("a", "b")
LENGTH = 8  # floats at the scattered end
TRACE_STEPS = 16
TRACE = dict(seed=11, rate=0.4, wavelengths=8)


def _case(cid, op, *, mode="perhop", chunks=None, regime="bandwidth",
          fault=None, retries=1):
    return dict(id=cid, op=op, mode=mode, chunks=chunks, regime=regime,
                fault=fault, retries=retries)


def _fault(axis, hop, mode, times, device=None):
    return dict(axis=axis, hop=hop, mode=mode, times=times, device=device)


VERIFIED = [
    # check_fault_tolerance.py section 1, on the per-hop AG plan
    _case("ag-healthy", "ag"),
    _case("ag-drop-once", "ag", fault=_fault("b", 1, "drop", 1)),
    _case("ag-corrupt-forever", "ag", fault=_fault("b", 2, "corrupt", 999)),
    # a fault on one ring position: the ranks' verdicts disagree
    _case("ag-drop-once-device1", "ag", fault=_fault("b", 1, "drop", 1, device=1)),
    _case("ag-corrupt-forever-device3", "ag",
          fault=_fault("b", 3, "corrupt", 999, device=3)),
    # the other collectives' ring stages and checksums
    _case("rs-drop-once", "rs", fault=_fault("b", 1, "drop", 1)),
    _case("ar-drop-once-a", "ar", fault=_fault("a", 1, "drop", 1)),
    _case("ar-corrupt-forever-device2", "ar",
          fault=_fault("b", 2, "corrupt", 999, device=2)),
    _case("a2a-corrupt-once", "a2a", fault=_fault("b", 3, "corrupt", 1)),
    _case("ag-corrupt-retries2", "ag", fault=_fault("a", 1, "corrupt", 2),
          retries=2),
    _case("ag-retries0-drop", "ag", fault=_fault("b", 1, "drop", 1), retries=0),
    # the exchange (latency) rounds
    _case("ag-exchange-drop-once", "ag", mode=None, regime="latency",
          fault=_fault("b", 2, "drop", 1)),
    _case("ar-exchange-corrupt-device0", "ar", mode=None, regime="latency",
          fault=_fault("a", 1, "corrupt", 999, device=0)),
    # a wavefront: no stage probes, one hop execution per chunk
    _case("ag-hybrid-corrupt-forever", "ag", mode="hybrid", chunks=2,
          fault=_fault("b", 1, "corrupt", 999)),
    _case("rs-hybrid-drop-once", "rs", mode="hybrid", chunks=2,
          fault=_fault("b", 2, "drop", 1)),
    # the blocking one-shot: no hop to fault
    _case("ar-oneshot-healthy", "ar", mode="oneshot"),
]
VERIFIED_IDS = [c["id"] for c in VERIFIED]

#: the counters the api sections write, in this order, under ``api#stats``
API_STATS = ("verify_drop_fallbacks", "verify_corrupt_fallbacks",
             "primed_plans", "replans_on_fault", "degraded_misses_delta",
             "dead_plans", "dead_is_fallback", "dead_fallbacks",
             "trace_events", "trace_replans")
#: the outputs the api sections write, each the 8 ranks' stacked
API_OUTPUTS = ("api-drop-once", "api-corrupt-forever", "want-ag", "want-ar",
               "degraded-ag", "degraded-ar", "dead-ag")

#: what the world asserts on every rank, check_fault_tolerance.py's checks
#: and the device-restricted fault's
CHECKS = (
    "verified ag healthy", "healthy: no fallback", "healthy: attempt 0 clean",
    "drop x1: recovered bits", "drop x1: detected on all devices",
    "drop x1: retry recovered (no fallback)", "drop x1: injection consumed once",
    "corrupt forever: fallback bits", "corrupt forever: detected",
    "corrupt forever: used fallback on all devices",
    "corrupt forever: both attempts injected",
    "device drop: every rank completed", "device drop: bits",
    "device drop: ranks disagree on attempt 0",
    "device drop: no fallback", "device drop: applied on every rank",
    "api verify: drop x1 bits", "api verify: retry not counted as fallback",
    "api verify: corrupt-forever bits", "api verify: executor fallback counted",
    "api verify: gradient through the dual collective",
    "cache primed", "fault changed the health fingerprint",
    "every cached plan re-planned in place", "degraded ag bits",
    "degraded ar bits", "degraded ops hit the re-planned cache",
    "degraded plans stamped with the health fp",
    "dead-axis fallback bits", "dead axis planned as one-shot fallback",
    "dead axis counted in CacheStats.fallbacks",
    "trace has events", "trace is deterministic",
    "trace loop re-planned on faults",
    f"all {TRACE_STEPS} trace-loop steps bit-identical to healthy run",
)


def local_shape(op: str):
    """This rank's input: the shard for AG, N blocks for RS, AR and a2a."""
    return (LENGTH,) if op == "ag" else (WORLD * LENGTH,)


def inputs(op: str) -> np.ndarray:
    """The 8 ranks' inputs stacked, (8, *local_shape): consecutive integers,
    so a lost or shifted block always changes a sum."""
    n = int(np.prod(local_shape(op)))
    return np.arange(WORLD * n, dtype=np.float32).reshape((WORLD,) + local_shape(op))


def trace_input(step: int) -> np.ndarray:
    """The trace loop's global array at ``step``: check_fault_tolerance.py's
    ``x + step``."""
    return np.arange(64, dtype=np.float32) + float(step)


def plan_row(plan) -> np.ndarray:
    """The plan a call ran, as strings: mode, chunks, stage modes, order."""
    return np.array([plan.mode, str(plan.num_chunks)] + list(plan.stage_modes)
                    + [str(a) for a in plan.axes])


def plan_for(case, api, ctx):
    """The plan ``case`` runs, built the same way in both packages: the
    context's plan for this rank's input, the overrides, the runtime fit."""
    op = case["op"]
    shape = local_shape(op)
    nbytes = 4.0 * int(np.prod(shape))
    if op in ("rs", "ar"):
        nbytes /= WORLD
    plan = ctx.plan(op, nbytes, shape=shape, regime=case["regime"])
    plan = api._apply_overrides(plan, case["mode"], case["chunks"])
    return api._fit_plan(plan, shape[0], 1 if op == "ag" else WORLD)
