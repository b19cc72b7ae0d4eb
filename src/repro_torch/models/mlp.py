"""Feed-forward blocks: SwiGLU (default) and GELU (hubert/w2v2).

The counterpart of ``repro/models/mlp.py:ffn_init/ffn_apply/mlp_init/mlp``
on one device (the tensor-parallel forms wait for the collectives port).
SwiGLU goes through ``kernels.ops.swiglu``: the CUDA kernel on the card.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense, dense_init

__all__ = ["ffn_init", "ffn_apply", "mlp_init", "mlp"]


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, num_layers: int, *,
             dtype: torch.dtype, device: torch.device, kind: str = "swiglu") -> Dict:
    down_scale = 0.02 / (2 * num_layers) ** 0.5
    kw = dict(dtype=dtype, device=device)
    if kind == "swiglu":
        return {
            "gate": dense_init(gen, d_model, d_ff, **kw),
            "up": dense_init(gen, d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, d_model, scale=down_scale, **kw),
        }
    if kind == "gelu":
        return {
            "up": dense_init(gen, d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, d_model, scale=down_scale, **kw),
        }
    raise ValueError(kind)


def ffn_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "gate" in p:
        h = ops.swiglu(dense(p["gate"], x), dense(p["up"], x))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["up"], x).float(), approximate="tanh").to(x.dtype)
    return dense(p["down"], h)


def mlp_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
             device: torch.device) -> Dict:
    kind = "gelu" if cfg.family == "audio" else "swiglu"
    return ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.num_layers, dtype=dtype,
                    device=device, kind=kind)


def mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return ffn_apply(p, x)
