"""Convert the reference's parameter pytree into the port's parameters.

``from_jax_params`` takes ``repro.models.init_params``'s tree with every
leaf already turned into a numpy array (so this module needs no jax), with
the reference's stacked leading layer axis, and returns the port's nested
dicts with ``layers`` as a per-layer list.  Names and layouts are the same
in both packages, so the conversion only splits the layer axis and moves
the arrays to torch; subtrees outside ``layers`` (zamba2's
``shared_block``) are moved as they are.  Each leaf keeps the dtype the
reference gave it: rwkv6's ``w0`` and ``u`` and Mamba2's ``a_log``,
``d_skip`` and ``dt_bias`` stay f32 in a bf16 model, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device

__all__ = ["from_jax_params"]

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
