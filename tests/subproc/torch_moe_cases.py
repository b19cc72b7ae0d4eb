"""The expert-parallel MoE cases the port's 8-rank world and the reference's
8 fake devices both run, and their inputs.

Numpy and the standard library only: ``torch_moe_world.py`` (torch),
``torch_moe_ref.py`` (jax) and the tests import it.  The block config is
``tests/subproc/check_plan_executor.py``'s (d 16, 16 experts, top-2,
d_ff_expert 24, a shared expert).  ``x`` is global, (B, S, d), split over
the mesh's axes on the batch dim (rank r holds rows ``r * B/8`` onwards,
device r of the reference's mesh); the weights are replicated, drawn in the
reference's layout at a scale that keeps activations of order 1.  A case is
a dict:

* ``kind``: ``fwd`` (output, aux and the plans issued) or ``grad`` (the
  gradients of every rank's ``sum(out * c_r) + load_balance + router_z``,
  summed over ranks);
* ``mesh``: a key of ``MESHES``; ``axis``: the expert axis; ``size``: a key
  of ``SIZES``.

``FULL`` is one rank's (B, S) in the card machine's ``[moe/gloo8]``
(``torch_moe_world.py --suite full``): llama4-scout-17b-a16e's MoE block at
full width, 2 experts a rank, f32.
"""
from __future__ import annotations

import json
import zlib
from typing import Dict

import numpy as np

WORLD = 8
#: built in this order on every rank (process groups are created in order)
MESHES = {"8": ((8,), ("ep",)), "2x4": ((2, 4), ("a", "b"))}
#: ModelConfig fields of check_plan_executor.py's MoE config
CONFIG = dict(name="check-moe-ep", family="moe", dtype="float32", remat=False,
              num_layers=2, d_model=16, num_heads=2, num_kv_heads=2, head_dim=8,
              d_ff=32, vocab_size=64)
MOE = dict(num_experts=16, top_k=2, d_ff_expert=24, shared_expert=True)
#: global x (B, S): "small" is check_plan_executor.py's (1 token a group,
#: no overflow); "overflow" gives each rank 32 groups of 8 tokens, 2 slots
#: an expert, and experts over capacity
SIZES = {"small": (16, 4), "overflow": (16, 128)}
#: [moe/gloo8]: one rank's B, S
FULL = dict(B=1, S=64)


def _cases():
    out = []
    for mesh, axis in (("8", "ep"), ("2x4", "a"), ("2x4", "b")):
        for size in SIZES:
            out.append(dict(id=f"fwd-{mesh}-{axis}-{size}", kind="fwd", mesh=mesh,
                            axis=axis, size=size))
        out.append(dict(id=f"grad-{mesh}-{axis}", kind="grad", mesh=mesh, axis=axis,
                        size="overflow"))
    return out


CASES = _cases()


def case_by_id(cid: str) -> Dict:
    return next(c for c in CASES if c["id"] == cid)


def seed_of(name: str) -> int:
    return zlib.crc32(name.encode()) % (2**31)


def moe_params(d: int, E: int, f: int, rng: np.random.Generator) -> Dict:
    """One MoE block in the reference's ``moe_init`` layout: the router f32,
    stacked (E, d, f) / (E, f, d) experts and the shared expert, each
    weight at 1/sqrt(fan-in)."""
    f32 = np.float32

    def draw(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(f32)

    return {"router": {"w": draw((d, E), d)},
            "experts": {"gate": draw((E, d, f), d), "up": draw((E, d, f), d),
                        "down": draw((E, f, d), f)},
            "shared": {"gate": {"w": draw((d, f), d)}, "up": {"w": draw((d, f), d)},
                       "down": {"w": draw((f, d), f)}}}


def inputs(case) -> Dict[str, np.ndarray]:
    """x (global), c (per-rank cotangents, stacked), and the parameters
    under ``p/`` (one set for every case of a size)."""
    rng = np.random.default_rng(seed_of(f"moe-{case['size']}"))
    B, S = SIZES[case["size"]]
    d = CONFIG["d_model"]
    p = moe_params(d, MOE["num_experts"], MOE["d_ff_expert"], rng)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    c = rng.standard_normal((WORLD, B // WORLD, S, d)).astype(np.float32)
    return {"x": x, "c": c, **{"p/" + k: v for k, v in flatten(p).items()}}


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def unflatten(flat: Dict) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_of(inp: Dict[str, np.ndarray]) -> Dict:
    return unflatten({k[2:]: v for k, v in inp.items() if k.startswith("p/")})


def plan_summary(plans) -> np.ndarray:
    """The plans a context issued, as sorted JSON strings (one encoding for
    the port's and the reference's ``CollectivePlan``): collective, n,
    shard bytes, mode, chunks, and each stage's axis, factor, mode and
    payload."""
    rows = []
    for p in plans:
        rows.append(json.dumps({
            "collective": p.collective, "n": int(p.n), "shard_bytes": float(p.shard_bytes),
            "mode": p.mode, "num_chunks": int(p.num_chunks),
            "stages": [[s.axis, int(s.factor), s.mode, float(s.payload_bytes)]
                       for s in p.stages]},
            sort_keys=True))
    return np.array(sorted(rows))
