"""Convert the reference's parameter pytree into the port's parameters.

``from_jax_params`` takes ``repro.models.init_params``'s tree with every
leaf already turned into a numpy array (so this module needs no jax), with
the reference's stacked leading layer axis, and returns the port's nested
dicts with ``layers`` as a per-layer list.  Names and layouts are the same
in both packages, so the conversion only splits the layer axis and moves
the arrays to torch; subtrees outside ``layers`` (zamba2's
``shared_block``) are moved as they are.  An MoE layer's stacked experts,
(L, E, d, f) in the reference, become (E, d, f) per layer.  Each leaf
keeps the dtype the reference gave it: rwkv6's ``w0`` and ``u``, Mamba2's
``a_log``, ``d_skip`` and ``dt_bias`` and the MoE router stay f32 in a
bf16 model, as in the reference.

``shard_tp_layer`` cuts one full layer into this rank's tensor-parallel
slice, the counterpart of the reference's ``shard_map`` in_specs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device

__all__ = ["from_jax_params", "shard_tp_layer"]

#: numpy dtype name (``ml_dtypes`` names jax's bfloat16) -> torch dtype
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(np_tree: Dict, cfg: ModelConfig,
                    device: Union[str, torch.device, None] = "cuda") -> Dict:
    dev = resolve_device(device)

    def to_torch(a) -> torch.Tensor:
        a = np.asarray(a)
        dtype = _DTYPES.get(a.dtype.name)
        if dtype is None:
            raise TypeError(f"from_jax_params takes float32 or bfloat16 leaves, got {a.dtype}")
        # via float32: numpy has no bfloat16 torch can read, and widening a
        # bf16 value to f32 and back is exact
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    params = {k: _map(v, to_torch) for k, v in np_tree.items() if k != "layers"}
    layers = np_tree["layers"]
    params["layers"] = [_map(layers, lambda a, i=i: to_torch(np.asarray(a)[i]))
                        for i in range(cfg.num_layers)]
    return params


def shard_tp_layer(layer: Dict, specs: Dict, mesh, names: Sequence[str]) -> Dict:
    """This rank's slice of ``layer`` under ``specs`` (a tree of the same
    keys whose leaves are the dimension split over the axis tuple
    ``names``, or None for a replicated leaf, as
    ``model.tp_block_specs`` gives them).

    A split dimension is cut into ``mesh.axis_size(names)`` equal blocks
    and this rank takes block ``mesh.axis_index(names)``: the row-major
    index over the tuple in the order given, as a ``PartitionSpec`` with a
    tuple of mesh axes linearises it (on a [2, 4] mesh named ("ta", "tb"),
    rank r takes block r under ("ta", "tb"), and block 2 * (r % 4) + r // 4
    under ("tb", "ta")).  Replicated leaves are returned as they are."""
    n = mesh.axis_size(names)
    idx = mesh.axis_index(names)

    def cut(a: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is None:
            return a
        if a.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(a.shape)} does not split into {n}")
        blk = a.shape[dim] // n
        return a.narrow(dim, idx * blk, blk).contiguous()

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return cut(tree, spec)

    return walk(layer, specs)
