"""Convert the reference's parameter pytree into the port's parameters.

``from_jax_params`` takes ``repro.models.init_params``'s tree with every
leaf already turned into a numpy array (so this module needs no jax), with
the reference's stacked leading layer axis, and returns the port's nested
dicts with ``layers`` as a per-layer list.  Names and layouts are the same
in both packages, so the conversion only splits the layer axis and moves
the arrays to torch.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .model import torch_dtype

__all__ = ["from_jax_params"]


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(np_tree: Dict, cfg: ModelConfig,
                    device: Union[str, torch.device, None] = "cuda") -> Dict:
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def to_torch(a) -> torch.Tensor:
        # via float32: numpy has no bfloat16 torch can read, and widening a
        # bf16 value to f32 and back is exact
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=dev, dtype=dtype)

    params = {k: _map(v, to_torch) for k, v in np_tree.items() if k != "layers"}
    layers = np_tree["layers"]
    params["layers"] = [_map(layers, lambda a, i=i: to_torch(np.asarray(a)[i]))
                        for i in range(cfg.num_layers)]
    return params
