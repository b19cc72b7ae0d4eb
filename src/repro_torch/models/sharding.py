"""Sharding rules: parameter, activation and cache specs, placed as DTensors.

The counterpart of ``repro/models/sharding.py``.  Its layout:

  * TP (``model``): attention QKV/O on the heads dim, the FFN on the hidden
    dim, experts on the expert dim (EP), the vocabulary on the vocab dim;
  * DP (``data`` [+ ``pod``]): the batch dim of activations; ZeRO-1 shards
    the optimizer state over ``data`` (``optim.opt_state_specs``).

A spec is :class:`P`, a backend-free copy of JAX's ``PartitionSpec``: one
entry a tensor dim, each ``None``, a mesh axis name or a tuple of names.
The spec functions read only ``mesh.shape`` as a mapping of axis names to
sizes (``axis_sizes`` also takes a ``DeviceMesh``), so the reference's
functions and these take the same stand-in mesh.  ``to_placements`` maps a
spec onto a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the axis names: one placement a mesh dim, ``Shard(d)``
where tensor dim ``d`` names that axis, ``Replicate()`` elsewhere.  A dim
over several axes is ``Shard(d)`` on each of them, major first, which is
the order JAX splits it in.  ``distribute_tree`` places a tree of tensors
by a tree of specs.

The reference stacks the layers on a leading dim and gives each layer leaf
``P(None, *inner)``; the port keeps ``params["layers"]`` as a list, so
``param_specs`` gives each layer's leaf the inner spec alone, without the
leading ``None``.  ``stack_layers`` / ``unstack_layers`` move a tree of
DTensors between the two layouts without moving data (the optimizer state
of the spec path keeps the reference's stacked layout).

``constrain`` is the reference's ``with_sharding_constraint``: under the
policy ``set_activation_policy`` installs it redistributes a DTensor to the
placements of its kind.  A plain tensor, or any tensor under no policy,
passes through unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.local import contiguous_stride, split_of
from ..tree import is_dtensor, tree_map

__all__ = [
    "P",
    "TP",
    "dp_axes",
    "axis_sizes",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "logits_spec",
    "sanitize_spec",
    "sanitize_tree",
    "fsdp_tree",
    "map_specs",
    "to_placements",
    "distribute_tree",
    "stack_layers",
    "unstack_layers",
    "whole_groups",
    "whole_sequence",
    "set_activation_policy",
    "constrain",
]

TP = "model"


def _entry(e):
    """JAX's normal form of one spec entry: a 1-tuple is its name."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: ``P(dp, None, "model")``.  Entries are ``None``, an
    axis name or a tuple of names; a 1-tuple is normalised to its name, as
    JAX's ``PartitionSpec`` does, so ``tuple(P(...))`` equals the
    reference's ``tuple(PartitionSpec(...))`` entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


#: the activation-sharding policy the launcher installs (None: activations
#: are not redistributed, as in every one-device path)
_ACT_POLICY: Optional[Dict] = None


def set_activation_policy(policy: Optional[Dict]) -> None:
    """``policy``: ``{"dp": (axis names), "tp": "model",
    "sequence_parallel": bool}``, or None."""
    global _ACT_POLICY
    _ACT_POLICY = policy


def _activation_spec(kind: str) -> Optional[P]:
    dp = _ACT_POLICY["dp"]
    tp = _ACT_POLICY.get("tp", TP)
    if kind == "hidden":  # (B, S, d)
        return P(dp, tp, None) if _ACT_POLICY.get("sequence_parallel") else P(dp, None, None)
    if kind == "logits":  # (B, S, V)
        return P(dp, None, tp)
    if kind == "tokens_flat":  # (T, d)
        return P(dp, None)
    if kind == "moe_buffer":  # (G, E, C, d): groups on dp, experts on tp
        return P(dp, tp, None, None)
    return None


def constrain(x, kind: str):
    """Redistribute the DTensor ``x`` to the placements of ``kind``
    (``hidden`` (B,S,d), ``logits`` (B,S,V), ``tokens_flat`` (T,d),
    ``moe_buffer`` (G,E,C,d)) under the installed policy; ``x`` itself when
    there is no policy, when ``x`` is a plain tensor, or for another kind."""
    if _ACT_POLICY is None or not is_dtensor(x):
        return x
    spec = _activation_spec(kind)
    if spec is None:
        return x
    mesh = x.device_mesh
    spec = sanitize_spec(spec, tuple(x.shape), mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))


def axis_sizes(mesh) -> Mapping[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (by its
    ``mesh_dim_names``) or of anything whose ``shape`` is that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh``, major first: ``pod`` then ``data``."""
    shape = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _leaf_spec(path: Tuple[str, ...], ndim: int) -> P:
    """Spec for one parameter leaf, path = tuple of dict keys (no layer dim)."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    gparent = path[-3] if len(path) >= 3 else ""

    # embeddings / head
    if name == "embed":
        return P(TP, None)
    if parent == "lm_head":
        return P(None, TP)

    # attention projections
    if parent in ("wq", "wk", "wv") and gparent in ("attn", "tmix", "cmix"):
        return P(None, TP) if name == "w" else P(TP)
    if parent == "wo" and name in ("w", "b"):
        return P(TP, None) if name == "w" else P(None)
    if parent in ("wg", "wr") and name == "w":
        return P(None, TP)
    if parent in ("wg", "wr") and name == "b":
        return P(TP)

    # dense FFN (also shared/dense branches of MoE)
    if parent in ("gate", "up") and name == "w":
        return P(None, TP)
    if parent == "down" and name == "w":
        return P(TP, None)
    # moe expert tensors are stacked (E, d, f)/(E, f, d): EP over experts
    if parent == "experts":
        return P(TP, None, None)
    if parent == "router":
        return P(None, None)

    # rwkv specifics
    if name == "u":
        return P(TP, None)
    if name in ("mu", "lora_a", "lora_b", "w0", "w_lora_a", "w_lora_b",
                "mu_k", "mu_r"):
        return P(*([None] * ndim))

    # mamba2
    if parent == "in_proj" and name == "w":
        return P(None, TP)
    if parent == "out_proj" and name == "w":
        return P(TP, None)
    if name == "conv_w":
        return P(None, TP)
    if name == "conv_b":
        return P(TP)
    if name in ("a_log", "d_skip", "dt_bias", "norm_scale"):
        return P(*([None] * ndim))

    # norms and anything residual: replicate
    return P(*([None] * ndim))


def _map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def map_specs(fn: Callable, specs: Any, *rest: Any) -> Any:
    """``fn(spec, *leaves)`` over a tree of :class:`P` and trees of the
    same structure (dicts and lists; a spec is a leaf, not a tuple)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(specs)]
    return fn(specs, *rest)


def param_specs(cfg: ModelConfig, params) -> Dict:
    """A tree of :class:`P` matching ``params``.  Each entry of
    ``params["layers"]`` (a per-layer dict) gets the reference's inner
    spec of that leaf: the stacked reference leaf's spec without its
    leading ``None``."""

    def spec(path, leaf):
        keys = tuple(str(k) for k in path)
        ndim = leaf.dim() if hasattr(leaf, "dim") else len(leaf.shape)
        if keys and keys[0] == "layers":
            return _leaf_spec(("layers",) + keys[2:], ndim)
        if keys and keys[0] == "embed":
            return P(TP, None)
        return _leaf_spec(keys, ndim)

    return _map_with_path(spec, params)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, P]:
    dp = dp_axes(mesh)
    specs: Dict[str, P] = {}
    if cfg.frontend == "audio":
        specs["embeds"] = P(dp, None, None)
    else:
        specs["tokens"] = P(dp, None)
    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["image_embeds"] = P(dp, None, None)
    if shape.kind == "train":
        specs["labels"] = P(dp, None)
    if shape.kind == "decode":
        specs["cache_pos"] = P()
    return specs


def cache_specs(cfg: ModelConfig, mesh) -> Dict:
    dp = dp_axes(mesh)
    tp_size = axis_sizes(mesh).get(TP, 1)
    # KV heads shard over 'model' when divisible; otherwise the sequence dim
    # (cfg.kv_shard overrides)
    if cfg.kv_shard == "heads" or (
        cfg.kv_shard == "auto" and cfg.num_kv_heads % tp_size == 0
    ):
        kv = P(None, dp, TP, None, None)
    else:
        kv = P(None, dp, None, TP, None)
    if cfg.family == "ssm":
        return {
            "rwkv": {
                "tmix_x": P(None, dp, None),
                "cmix_x": P(None, dp, None),
                "wkv": P(None, dp, TP, None, None),
            }
        }
    if cfg.family == "hybrid":
        return {
            "mamba": {
                "conv": P(None, dp, None, TP),
                "ssm": P(None, dp, TP, None, None),
            },
            "shared_k": kv,
            "shared_v": kv,
        }
    return {"k": kv, "v": kv}


def logits_spec(mesh) -> P:
    return P(dp_axes(mesh), None, TP)


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    shape = axis_sizes(mesh)
    size = 1
    for n in names:
        size *= shape[n]
    return size


def sanitize_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop sharded dims whose size the mesh axes do not divide: placed
    leaves are split evenly (operations inside a step may still meet an
    uneven split, which DTensor redistributes)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for entry, dim in zip(parts, shape):
        size = _axes_size(mesh, entry)
        out.append(entry if (size > 1 and dim % size == 0) or size == 1 else None)
    return P(*out)


def sanitize_tree(specs, shapes, mesh):
    """``sanitize_spec`` over a tree of specs and a tree of anything with
    a ``shape`` (tensors)."""
    return map_specs(lambda s, t: sanitize_spec(s, tuple(t.shape), mesh), specs, shapes)


def _used_axes(parts) -> set:
    return {a for p in parts if p is not None for a in (p if isinstance(p, tuple) else (p,))}


def fsdp_tree(specs, shapes, mesh):
    """ZeRO-3/FSDP: also shard every parameter over ``data`` on its first
    unsharded dim that ``data`` divides."""
    data = axis_sizes(mesh).get("data", 1)

    def f(spec, t):
        parts = list(spec) + [None] * (len(t.shape) - len(spec))
        if "data" in _used_axes(parts):
            return P(*parts)
        for i, (p, dim) in enumerate(zip(parts, t.shape)):
            if p is None and dim % data == 0 and dim >= data:
                parts[i] = "data"
                break
        return P(*parts)

    return map_specs(f, specs, shapes)


def to_placements(spec: P, mesh) -> List:
    """One placement a dim of the ``DeviceMesh`` ``mesh``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` of ``spec`` names, ``Replicate()``
    on the rest.  The axes of one entry must come in the mesh's order (the
    major one first), the order in which DTensor splits a dim over several
    mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: List = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names axes {missing} that mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} must come in the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names axis {names[i]!r} twice")
            out[i] = Shard(d)
    return out


def distribute_tree(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` placed by its spec.
    Every rank must hold the same full tensors: each keeps its own shard
    of them and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return map_specs(
        lambda s, t: distribute_tensor(t.detach(), mesh, to_placements(s, mesh),
                                       src_data_rank=None),
        specs, tree)


def whole_groups(x, dim: int, groups: int):
    """``x`` with no mesh dim splitting ``dim`` into pieces that cut its
    ``groups`` (heads) apart: a DTensor whose split of ``dim`` does not
    divide ``groups`` is redistributed to ``Replicate()`` on those mesh
    dims (DTensor refuses to unflatten such a split); anything else is
    returned as it is.  Reduced granite's 2 KV heads over a model axis of 4
    take this path."""
    if not is_dtensor(x) or groups % split_of(x, x.placements, dim % x.dim()) == 0:
        return x
    return _whole(x, dim % x.dim())


def whole_sequence(x):
    """``x`` (B, S, ...) with its sequence dim whole: a DTensor split over
    the sequence (the sequence-parallel residual stream, ``hidden`` under
    ``sequence_parallel``) is gathered there, GSPMD's all-gather before a
    token mixer; anything else is returned as it is.  The projections
    flatten (B, S) into rows, which DTensor refuses while S is split."""
    return _whole(x, 1) if is_dtensor(x) else x


def _whole(x, d: int):
    """The DTensor ``x`` replicated on the mesh dims that split tensor dim
    ``d``, or ``x`` itself where none does."""
    from torch.distributed.tensor import Replicate, Shard

    cut = [isinstance(p, Shard) and p.dim % x.dim() == d for p in x.placements]
    if not any(cut):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if c else p for c, p in zip(cut, x.placements)])


def _shifted(placements, by: int) -> List:
    from torch.distributed.tensor import Shard

    return [Shard(p.dim + by) if isinstance(p, Shard) else p for p in placements]


def stack_layers(layers: List[Any]) -> Any:
    """The per-layer trees of ``layers`` stacked on a new leading dim, leaf
    by leaf.  DTensor leaves of one name must share their placements: each
    rank stacks its local shards (``Shard(d)`` becomes ``Shard(d + 1)``),
    and nothing is sent."""
    import torch
    from torch.distributed.tensor import DTensor

    def stack(*xs):
        if not isinstance(xs[0], DTensor):
            return torch.stack(xs)
        pl = xs[0].placements
        if any(x.placements != pl for x in xs):
            raise ValueError(f"stack_layers: placements differ across layers: "
                             f"{[x.placements for x in xs]}")
        local = torch.stack([x.to_local() for x in xs])
        return DTensor.from_local(local, xs[0].device_mesh, _shifted(pl, 1),
                                  run_check=False, shape=(len(xs),) + tuple(xs[0].shape),
                                  stride=contiguous_stride((len(xs),) + tuple(xs[0].shape)))

    return tree_map(stack, layers[0], *layers[1:])


def unstack_layers(stacked: Any, like: List[Any]) -> List[Any]:
    """``stacked`` (a tree of leaves stacked on dim 0, not sharded there)
    back into one tree a layer in the structure of ``like``; each DTensor
    leaf is a view of this rank's shard."""
    from torch.distributed.tensor import DTensor, Shard

    def pick(s, i):
        if not isinstance(s, DTensor):
            return s[i]
        if any(isinstance(p, Shard) and p.dim == 0 for p in s.placements):
            raise ValueError("unstack_layers: the layer dim is sharded")
        shape = tuple(s.shape[1:])
        return DTensor.from_local(s.to_local()[i], s.device_mesh, _shifted(s.placements, -1),
                                  run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))

    return [tree_map(lambda _, s, i=i: pick(s, i), layer, stacked)
            for i, layer in enumerate(like)]
