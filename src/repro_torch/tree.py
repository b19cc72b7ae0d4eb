"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

Parameters, optimizer state and checkpoints are nested dicts and lists
(``params["layers"]`` is a per-layer list).  These helpers walk them in a
fixed order: dict items in insertion order, list and tuple items by index.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List

import torch

__all__ = ["is_dtensor", "tree_leaves", "tree_map", "tree_flatten_with_keys", "tree_copy_"]


def is_dtensor(x) -> bool:
    """True for a DTensor (without importing DTensor where none can exist)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); returns a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_flatten_with_keys(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves by "/"-joined key (dict keys, list indices), as the reference
    checkpointer's ``_flatten`` names them."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(tree_flatten_with_keys(v, f"{prefix}/{k}" if prefix else k))
    return out


def tree_copy_(dst: Any, src: Any) -> None:
    """Copy each leaf of ``src`` into the matching tensor of ``dst``, in
    place and outside autograd.  Where ``dst`` is a DTensor and ``src`` the
    full tensor (the same on every rank), each rank copies its shard."""
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            if is_dtensor(d) and not is_dtensor(s):
                from torch.distributed.tensor import distribute_tensor

                s = distribute_tensor(s.to(d.device), d.device_mesh, d.placements,
                                      src_data_rank=None)
            d.copy_(s)
