"""The tensor-parallel cases the port's 8-rank world and the reference's 8
fake devices both run, their inputs and the numpy truth where one exists.

Numpy and the standard library only: ``torch_tp_world.py`` (torch),
``torch_tp_ref.py`` (jax) and the tests import it.  Every input is one
array per rank, stacked on a leading axis of ``WORLD`` in rank order (rank
r is device r of the reference's mesh), drawn from a seed made from the
case id.  A case is a dict:

* ``kind``: ``ops`` (``api.allgather_matmul`` with one weight and with a
  pair, ``api.matmul_reduce_scatter``), ``ops_grad`` (their gradients: of
  a sum over ranks of each rank's loss), ``ffn_tp_grad`` (``ffn_apply_tp``
  and its gradient), ``ffn_sp_grad`` (``ffn_apply_tp_sp``'s gradient),
  ``block`` (``transformer_block_tp``), ``decode``
  (``sharded_decode_attention`` at each of ``DECODE_VALID``) or ``zero1``;
* ``mesh``: a key of ``MESHES``; ``names``: the context's axis tuple;
* ``fuse``: the context policy's collective-matmul fusion;
* ``ints``: integer-valued f32 inputs, so every sum is exact and the
  outputs are compared bit for bit.

``full_cases()`` are the full-width granite-3-2b blocks of the card
machine's ``[tp/gloo8]`` phase (``BLOCK["full"]``); the tests run
``CASES`` (``BLOCK["small"]``).
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

WORLD = 8
#: built in this order on every rank (process groups are created in order)
MESHES = {"8": ((8,), ("t",)), "2x4": ((2, 4), ("ta", "tb"))}
FUSES = (True, False, "auto")

#: ModelConfig fields over granite-3-2b's, by config name (f32, 2 layers)
CONFIGS = {
    # GQA as in granite (2 query heads a kv head); 8 kv heads for 8 ranks
    "granite": dict(d_model=64, num_heads=16, num_kv_heads=8, head_dim=16, d_ff=128),
    "bias": dict(d_model=32, num_heads=8, num_kv_heads=8, head_dim=16, d_ff=64,
                 qkv_bias=True),
    "qknorm": dict(d_model=32, num_heads=8, num_kv_heads=8, head_dim=16, d_ff=64,
                   qk_norm=True),
    # granite-3-2b at full width: d 2048, 32/8 heads of 64, d_ff 8192
    "granite_full": dict(d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
                         d_ff=8192),
}
COMMON = dict(num_layers=2, vocab_size=256, dtype="float32", remat=False)


def config_fields(name: str) -> Dict:
    fields = dict(COMMON, qkv_bias=False, qk_norm=False)
    fields.update(CONFIGS[name])
    return fields


def seed_of(cid: str) -> int:
    return zlib.crc32(cid.encode()) % (2**31)


def block_index(mesh: str, names) -> np.ndarray:
    """``index[r]``: rank r's index over the axis tuple ``names``, row-major
    in the tuple's order, as the reference linearises an axis tuple."""
    factors, axes = MESHES[mesh]
    coords = np.stack(np.unravel_index(np.arange(WORLD), factors), axis=1)
    idx = np.zeros(WORLD, dtype=np.int64)
    for n in names:
        a = axes.index(n)
        idx = idx * factors[a] + coords[:, a]
    return idx


def rank_blocks(mesh: str, names) -> np.ndarray:
    """``order[i]``: the rank holding block i over the full tuple ``names``."""
    return np.argsort(block_index(mesh, names))


def layer_init(cfg: Dict, rng: np.random.Generator) -> Dict:
    """One dense layer in the reference's ``_layer_init`` layout, drawn from
    ``rng``: weights at a scale that keeps activations of order 1, norm
    scales near 1 and non-zero biases (the reference's are zeros, which
    would hide a bias added twice)."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    q_dim = cfg["num_heads"] * cfg["head_dim"]
    kv_dim = cfg["num_kv_heads"] * cfg["head_dim"]
    f32 = np.float32

    def dense(d_in, d_out, bias=False):
        p = {"w": (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(f32)}
        if bias:
            p["b"] = (0.1 * rng.standard_normal(d_out)).astype(f32)
        return p

    def norm(n):
        return {"scale": (1.0 + 0.1 * rng.standard_normal(n)).astype(f32)}

    attn = {"wq": dense(d, q_dim, cfg["qkv_bias"]), "wk": dense(d, kv_dim, cfg["qkv_bias"]),
            "wv": dense(d, kv_dim, cfg["qkv_bias"]), "wo": dense(q_dim, d)}
    if cfg["qk_norm"]:
        attn["q_norm"] = norm(cfg["head_dim"])
        attn["k_norm"] = norm(cfg["head_dim"])
    return {"ln1": norm(d), "attn": attn, "ln2": norm(d),
            "ffn": {"gate": dense(d, ff), "up": dense(d, ff), "down": dense(ff, d)}}


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


# --------------------------------------------------------------------------
# cases and their inputs
# --------------------------------------------------------------------------

#: the fused-op shapes: B, scattered S per rank, d_in, d_out
OP_SHAPE = dict(B=2, S=2, D=8, F=6)
#: sharded_decode_attention: B, H, Hkv, T (global), hd
DECODE = dict(B=2, H=4, Hkv=2, T=64, hd=16)
#: the valid lengths: at 1, ranks 1..7 hold no valid key
DECODE_VALID = (1, 17, 40, 64)
BLOCK = {"small": dict(B=2, S=16), "full": dict(B=1, S=256)}


def _cases_small():
    out = []

    def add(cid, **kw):
        out.append(dict(id=cid, **kw))

    tags = {"8": ("8", ("t",)), "2x4": ("2x4", ("ta", "tb")),
            "2x4-ba": ("2x4", ("tb", "ta"))}
    for tag, (mesh, names) in tags.items():
        kw = dict(mesh=mesh, names=names)
        # the fused ops on integer inputs (one weight, a pair, and the
        # matmul -> reduce-scatter): every fuse setting, and the fused rings
        # in the reversed axis order
        for fuse in FUSES if tag != "2x4-ba" else (True,):
            add(f"ops-{tag}-{fuse}", kind="ops", fuse=fuse, ints=True, **kw)
        # their gradients: the fused rings' own backward, and the planned
        # collectives' duals
        for fuse in (True, False) if tag != "2x4-ba" else (True,):
            add(f"ops_grad-{tag}-{fuse}", kind="ops_grad", fuse=fuse, ints=False, **kw)
        # the block under the default policy: granite on every mesh, the
        # bias and q/k-norm branches on the reversed [2, 4]
        for cfg in ("granite", "bias", "qknorm") if tag == "2x4-ba" else ("granite",):
            for sp in (False, True):
                add(f"block-{cfg}-{tag}-{'sp' if sp else 'tp'}-auto", kind="block",
                    cfg=cfg, sp=sp, fuse="auto", mode="small", ints=False, **kw)
    for tag in ("8", "2x4-ba"):
        mesh, names = tags[tag]
        for fuse in (True, False):
            add(f"ffn_sp_grad-{tag}-{fuse}", kind="ffn_sp_grad", cfg="granite",
                mesh=mesh, names=names, fuse=fuse, ints=False)
        add(f"ffn_tp_grad-{tag}", kind="ffn_tp_grad", cfg="granite", mesh=mesh,
            names=names, fuse="auto", ints=False)
    # SP with the fused rings forced on and off
    for fuse in (True, False):
        add(f"block-granite-2x4-sp-{fuse}", kind="block", cfg="granite", mesh="2x4",
            names=("ta", "tb"), sp=True, fuse=fuse, mode="small", ints=False)
    add("decode", kind="decode", mesh="8", names=("t",), fuse="auto", ints=False)
    for fast, slow in ((("ta", "tb"), ()), (("tb",), ("ta",))):
        add(f"zero1-{''.join(fast)}-{''.join(slow) or 'none'}", kind="zero1",
            mesh="2x4", names=("ta", "tb"), fast=fast, slow=slow, fuse="auto", ints=True)
    return out


def full_cases():
    """``[tp/gloo8]``: full-width granite-3-2b, meshes [8] and [2, 4], TP and
    SP, every fuse setting."""
    out = []
    for mesh, names in (("8", ("t",)), ("2x4", ("ta", "tb"))):
        for sp in (False, True):
            for fuse in FUSES:
                out.append(dict(id=f"block-granite_full-{mesh}-{'sp' if sp else 'tp'}-{fuse}",
                                kind="block", cfg="granite_full", mesh=mesh, names=names,
                                sp=sp, fuse=fuse, mode="full", ints=False))
    return out


CASES = _cases_small()
CASE_IDS = [c["id"] for c in CASES]


def case_by_id(cid: str) -> Dict:
    return next(c for c in CASES + full_cases() if c["id"] == cid)


def _draw(rng, shape, ints):
    if ints:
        return rng.integers(-8, 8, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def inputs(case) -> Dict[str, np.ndarray]:
    """The case's inputs by name; per-rank arrays stacked on axis 0."""
    # a block's layer and input depend on its config and size only, so the
    # reference's full block is one computation a config
    seed_id = (f"block-{case['cfg']}-{case['mode']}" if case["kind"] == "block"
               else case["id"])
    rng = np.random.default_rng(seed_of(seed_id))
    kind, W = case["kind"], WORLD
    B, S, D, F = (OP_SHAPE[k] for k in "BSDF")
    ints = case["ints"]
    if kind in ("ops", "ops_grad"):
        # allgather_matmul of x with w0 alone and with the pair (w0, w1);
        # matmul_reduce_scatter of h with v
        out = {"x": _draw(rng, (W, B, S, D), ints), "w0": _draw(rng, (W, D, F), ints),
               "w1": _draw(rng, (W, D, F), ints), "h": _draw(rng, (W, B, W * S, F), ints),
               "v": _draw(rng, (W, F, D), ints)}
        if kind == "ops_grad":
            # the cotangents of g, o0, o1 and y; and an all_to_all of a, so
            # that every planned collective's dual runs (all_reduce's in
            # ffn_tp_grad)
            out.update(cg=_draw(rng, (W, B, W * S, D), False),
                       c0=_draw(rng, (W, B, W * S, F), False),
                       c1=_draw(rng, (W, B, W * S, F), False),
                       cy=_draw(rng, (W, B, S, D), False),
                       a=_draw(rng, (W, W * S, D), False),
                       ca=_draw(rng, (W, W * S, D), False))
        return out
    if kind in ("ffn_tp", "ffn_tp_grad", "ffn_sp_grad", "block"):
        cfg = config_fields(case["cfg"])
        dims = BLOCK[case.get("mode", "small")]
        layer = layer_init(cfg, rng)
        x = rng.standard_normal((dims["B"], dims["S"], cfg["d_model"])).astype(np.float32)
        out = {"x": x, **{"layer/" + k: v for k, v in flatten(layer).items()}}
        if kind == "ffn_tp_grad":
            out["c"] = rng.standard_normal((W,) + x.shape).astype(np.float32)
        return out
    if kind == "decode":
        d = DECODE
        return {"q": (0.4 * rng.standard_normal((d["B"], d["H"], 1, d["hd"]))).astype(np.float32),
                "k": (0.4 * rng.standard_normal((d["B"], d["Hkv"], d["T"], d["hd"]))
                      ).astype(np.float32),
                "v": rng.standard_normal((d["B"], d["Hkv"], d["T"], d["hd"])).astype(np.float32)}
    if kind == "zero1":
        return {"g/w": _draw(rng, (W, 64, 4), True), "g/b": _draw(rng, (W, 5), True)}
    raise ValueError(kind)


def layer_of(inp: Dict[str, np.ndarray]) -> Dict:
    return unflatten({k[len("layer/"):]: v for k, v in inp.items() if k.startswith("layer/")})
