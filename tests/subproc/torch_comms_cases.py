"""The execution cases the port's 8-rank world and the reference's 8 fake
devices both run, their inputs and the numpy one-shot truth.

Numpy and the standard library only: ``torch_comms_world.py`` (torch),
``torch_comms_ref.py`` (jax) and ``tests/test_torch_comms_exec.py`` import
it.  A case is a dict:

* ``mesh``: a key of ``MESHES``; ``names``: the context's axis tuple
  (default the mesh's own);
* ``op``: ``ag``/``rs``/``ar``/``a2a`` (the ``api`` op of that collective),
  a baseline of ``collectives.py`` with its ``args``, ``exec``: the
  executor ``fn`` of the package called with ``kwargs``, or the deprecated
  ``engine`` (``StagedCollectiveEngine``'s method) and ``tp_all_reduce``,
  each computing the collective ``kind``;
* ``mode``/``chunks``: the per-call overrides; ``regime``/``order``: the
  context policy; ``links``: ``"asym"`` for the asymmetric table of
  ``tests/subproc/check_plan_executor.py`` (with ``order`` searched under a
  2-wavelength optical system);
* ``shape``: this rank's input; ``axis``: the op's axis.

Inputs are integer-valued float32 in [-64, 64) drawn from a seed made from
the case id, so every sum of 8 is exact and any reduction order gives the
same bits.
"""
from __future__ import annotations

import zlib

import numpy as np

WORLD = 8
#: built in this order on every rank (process groups are created in order)
MESHES = {
    "2x4": ((2, 4), ("a", "b")),
    "2x2x2": ((2, 2, 2), ("a", "b", "c")),
    "8": ((8,), ("x",)),
}
#: tests/subproc/check_plan_executor.py's asymmetric links: the size-4 axis
#: rides the slow transport, so the electrical and optical orders differ
ASYM = {"a": ("fast", 50e9, 1e-6), "b": ("slow", 1e9, 1e-5)}
OPTICAL_W = 2
MODES = ((None, None), ("oneshot", None), ("chunked", 2), ("chunked", 4),
         ("perhop", None), ("hybrid", 2), ("hybrid", 4))
COLLS = ("ag", "rs", "ar", "a2a")


def _shape(op: str, n: int, length: int):
    """Local input of a collective whose scattered end holds ``length``
    floats: the shard for AG, N blocks for RS, AR and a2a."""
    return (length,) if op == "ag" else (n * length,)


def _mode_tag(mode, chunks):
    return (mode or "planned") + (f"x{chunks}" if chunks else "")


def cases():
    out = []

    def add(cid, **kw):
        kw.setdefault("axis", 0)
        out.append(dict(id=cid, **kw))

    for mesh in ("2x4", "2x2x2"):
        # every collective in every mode, 16 floats at the scattered end
        for op in COLLS:
            for mode, chunks in MODES:
                add(f"{mesh}-{op}-{_mode_tag(mode, chunks)}", mesh=mesh, op=op,
                    mode=mode, chunks=chunks, shape=_shape(op, WORLD, 16))
        # the planner's own mode at 64 KiB shards, where it chunks
        for op in COLLS:
            add(f"{mesh}-{op}-planned-64KiB", mesh=mesh, op=op,
                shape=_shape(op, WORLD, 2**14))
        # a 2-D array gathered and scattered along its dim 1
        for op in COLLS:
            length = 16 if op == "ag" else WORLD * 16
            add(f"{mesh}-{op}-perhop-axis1", mesh=mesh, op=op, mode="perhop",
                shape=(3, length), axis=1)
        # both stage orders of the cross-world search on the asymmetric
        # table, planned and forced hybrid, at 64 KiB
        for order in ("electrical", "optical"):
            for op in COLLS:
                for mode, chunks in ((None, None), ("hybrid", 2)):
                    add(f"{mesh}-{op}-order_{order}-{_mode_tag(mode, chunks)}",
                        mesh=mesh, op=op, mode=mode, chunks=chunks, links="asym",
                        order=order, shape=_shape(op, WORLD, 2**14))
        # a forced reversed stage order
        names = MESHES[mesh][1]
        for op in COLLS:
            add(f"{mesh}-{op}-order_reversed-perhop", mesh=mesh, op=op,
                mode="perhop", order=tuple(reversed(names)),
                shape=_shape(op, WORLD, 16))
        # the latency regime: auto at a decode-size payload (128 B shards)
        # and forced
        for op in ("ag", "rs", "ar"):
            for regime in ("auto", "latency"):
                add(f"{mesh}-{op}-latency_{regime}", mesh=mesh, op=op,
                    links="asym", regime=regime, shape=_shape(op, WORLD, 32))
    # the executors called directly: every stage a ppermute ring (the
    # planner keeps size-2 stages one-shot), in a non-canonical order, and
    # the blocking staged primitives
    for mesh in ("2x4", "2x2x2"):
        names = MESHES[mesh][1]
        k = len(names)
        order = names[1:] + names[:1]
        for kind, fn in (("ag", "perhop_all_gather"), ("rs", "perhop_reduce_scatter"),
                         ("a2a", "perhop_all_to_all")):
            add(f"{mesh}-exec-{fn}-ring", mesh=mesh, op="exec", fn=fn, kind=kind,
                kwargs=dict(stage_order=order, stage_modes=("ring",) * k),
                shape=_shape(kind, WORLD, 16))
            hfn = fn.replace("perhop", "hybrid")
            add(f"{mesh}-exec-{hfn}-ring", mesh=mesh, op="exec", fn=hfn, kind=kind,
                kwargs=dict(stage_order=order, stage_modes=("ring",) * k, num_chunks=2),
                shape=_shape(kind, WORLD, 16))
        for fn in ("perhop_all_reduce", "hybrid_all_reduce"):
            kw = dict(rs_order=order, stage_modes=("ring",) * (2 * k))
            if fn.startswith("hybrid"):
                kw["num_chunks"] = 2
            add(f"{mesh}-exec-{fn}-ring", mesh=mesh, op="exec", fn=fn, kind="ar",
                kwargs=kw, shape=_shape("ar", WORLD, 16))
        gather_orders = dict.fromkeys((order, names, tuple(reversed(names))))
        for kind, fn, kw in tuple(
                ("ag", "staged_all_gather", dict(stage_order=o)) for o in gather_orders) + (
                ("ag", "staged_all_gather_chunked", dict(stage_order=order, num_chunks=4)),
                ("rs", "staged_reduce_scatter", dict(stage_order=order, num_chunks=2)),
                ("ar", "staged_all_reduce", dict(rs_order=order, num_chunks=2)),
                ("a2a", "staged_all_to_all", dict(stage_order=order, num_chunks=2))):
            tag = "-".join(kw["stage_order" if "stage_order" in kw else "rs_order"])
            add(f"{mesh}-exec-{fn}-{tag}", mesh=mesh, op="exec", fn=fn, kind=kind,
                kwargs=kw, shape=(3,) + _shape(kind, WORLD, 16), axis=1)
    # a context whose axis tuple is not in mesh order: blocks follow the
    # tuple, as the reference's collectives over an axis tuple do
    for op in COLLS:
        add(f"2x4-names_ba-{op}-perhop", mesh="2x4", names=("b", "a"), op=op,
            mode="perhop", shape=_shape(op, WORLD, 16))
        add(f"2x4-names_ba-{op}-oneshot", mesh="2x4", names=("b", "a"), op=op,
            mode="oneshot", shape=_shape(op, WORLD, 16))
    # the deprecated shims: the engine's methods and tp_all_reduce (the
    # latter under an installed comm_context over the mesh)
    for kind in ("ag", "rs", "ar"):
        add(f"2x4-engine-{kind}", mesh="2x4", op="engine", kind=kind,
            shape=_shape(kind, WORLD, 16))
    add("2x4-tp_all_reduce", mesh="2x4", op="tp_all_reduce", kind="ar",
        shape=(3, WORLD * 4), axis=-1)
    # the baselines of collectives.py
    add("base-one_stage_all_gather-2x4", mesh="2x4", op="one_stage_all_gather",
        args=(("a", "b"),), shape=(3, 8), axis=1)
    add("base-reduce_scatter-2x4-b", mesh="2x4", op="reduce_scatter",
        args=("b",), shape=(4 * 8, 3))
    for mesh, axis_name in (("2x4", "b"), ("2x4", "a"), ("8", "x")):
        add(f"base-ring_all_gather-{mesh}-{axis_name}", mesh=mesh,
            op="ring_all_gather", args=(axis_name,), shape=(8, 3))
        add(f"base-neighbor_exchange_all_gather-{mesh}-{axis_name}", mesh=mesh,
            op="neighbor_exchange_all_gather", args=(axis_name,), shape=(3, 8),
            axis=1)
    for mesh, fast, slow in (("2x4", ("b",), ("a",)), ("2x2x2", ("b", "c"), ("a",)),
                             ("8", ("x",), ())):
        for gather in (True, False):
            add(f"base-hierarchical_all_reduce-{mesh}-gather{int(gather)}",
                mesh=mesh, op="hierarchical_all_reduce", args=(fast, slow),
                gather=gather, shape=(WORLD * 8,))
    return out


CASES = cases()
assert len({c["id"] for c in CASES}) == len(CASES), "case ids must be unique"
CASE_IDS = [c["id"] for c in CASES]


def case_by_id(cid):
    return next(c for c in CASES if c["id"] == cid)


def inputs(case) -> np.ndarray:
    """(WORLD, *shape): rank r's input is row r."""
    rng = np.random.default_rng(zlib.crc32(case["id"].encode()))
    return rng.integers(-64, 64, size=(WORLD,) + tuple(case["shape"])).astype(np.float32)


# --------------------------------------------------------------------------
# numpy one-shot truth
# --------------------------------------------------------------------------

def _members(mesh: str, rank: int, axes):
    """Global ranks of rank's group over ``axes``, in the tuple's row-major
    order, and rank's index among them."""
    factors, names = MESHES[mesh]
    coords = list(np.unravel_index(rank, factors))
    dims = [names.index(a) for a in axes]
    sizes = [factors[d] for d in dims]
    members = []
    for sub in np.ndindex(*sizes):
        c = list(coords)
        for d, v in zip(dims, sub):
            c[d] = v
        members.append(int(np.ravel_multi_index(c, factors)))
    return members, members.index(rank)


def _gather(x, mesh, r, axes, axis):
    m, _ = _members(mesh, r, axes)
    return np.concatenate([x[q] for q in m], axis=axis)


def _sum(x, mesh, r, axes):
    m, _ = _members(mesh, r, axes)
    return np.sum([x[q] for q in m], axis=0, dtype=np.float32)


def _scatter(x, mesh, r, axes, axis):
    m, i = _members(mesh, r, axes)
    return np.split(_sum(x, mesh, r, axes), len(m), axis=axis)[i]


def _a2a(x, mesh, r, axes, axis):
    m, i = _members(mesh, r, axes)
    return np.concatenate([np.split(x[q], len(m), axis=axis)[i] for q in m], axis=axis)


def truth(case) -> np.ndarray:
    """(WORLD, *out): rank r's expected output, from numpy alone."""
    x = inputs(case)
    mesh, op, axis = case["mesh"], case["op"], case["axis"]
    names = tuple(case.get("names") or MESHES[mesh][1])
    if op in ("exec", "engine", "tp_all_reduce"):
        op = case["kind"]
    rows = []
    for r in range(WORLD):
        if op in ("ag", "one_stage_all_gather", "ring_all_gather",
                  "neighbor_exchange_all_gather"):
            axes = names if op == "ag" else case["args"][0]
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            rows.append(_gather(x, mesh, r, axes, axis))
        elif op in ("rs", "reduce_scatter"):
            axes = names if op == "rs" else (case["args"][0],)
            rows.append(_scatter(x, mesh, r, axes, axis))
        elif op == "ar":
            rows.append(_sum(x, mesh, r, names))
        elif op == "a2a":
            rows.append(_a2a(x, mesh, r, names, axis))
        elif op == "hierarchical_all_reduce":
            fast, slow = case["args"]
            total = tuple(fast) + tuple(slow)
            if case["gather"]:
                rows.append(_sum(x, mesh, r, total))
            else:
                m, i = _members(mesh, r, tuple(fast))
                rows.append(np.split(_sum(x, mesh, r, total), len(m), axis=axis)[i])
        else:
            raise ValueError(f"unknown op {op!r}")
    return np.stack(rows)
