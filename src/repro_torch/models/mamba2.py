"""Mamba2 (SSD) block for the zamba2 hybrid backbone.

The counterpart of ``repro/models/mamba2.py``.  State-space recurrence per
head (P = head_dim, N = state_dim)::

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * (x_t B_t^T)     h: (P, N)
    y_t = h_t C_t + D * x_t

with a width-4 causal depthwise conv on (x, B, C), a silu(z) gate, a per-head
group norm and the output projection.  The time recurrence is
``kernels.ops.mamba2_ssd_scan``: the CUDA kernel on the card, its plain
version on the CPU.  The reference runs the same arithmetic in its own
``lax.scan``, time-chunked under ``jax.checkpoint`` when ``scan_chunk``
divides S; that remat only trims what the backward pass keeps, so this
forward-only port leaves it out.

The reference's casts are kept as they are: ``a_log``, ``d_skip`` and
``dt_bias`` are f32 leaves in a model of any dtype; silu runs in f32 and is
cast back; dt, the decay and the scan are f32, and ``y + D x`` is formed in
f32 before the cast to the model's dtype.  The scan takes x, B and C as the
views the split of ``xBC`` gives, with no copy.

Decode state per layer: ``{"conv": (B, K-1, d_in + 2N) in the model dtype,
"ssm": (B, H, P, N) f32}``, O(1) per token.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense, dense_init, group_norm

__all__ = ["mamba2_init", "mamba2_block", "mamba2_state_init"]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    d_in = cfg.ssm.expand * cfg.d_model
    P = cfg.ssm.head_dim
    H = d_in // P
    N = cfg.ssm.state_dim
    conv_ch = d_in + 2 * N
    return d_in, P, H, N, conv_ch


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
                device: torch.device) -> Dict:
    """The reference's distributions and scales, drawn from ``gen``."""
    d = cfg.d_model
    d_in, P, H, N, conv_ch = _dims(cfg)
    out_scale = 0.02 / (2 * cfg.num_layers) ** 0.5
    kw = dict(dtype=dtype, device=device)
    conv_w = torch.randn((cfg.ssm.conv_dim, conv_ch), generator=gen, device=device) * 0.1
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * N + H, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), **kw),
        # f32 whatever the model's dtype; A = -exp(a_log) = -1
        "a_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_in,), **kw),
        "out_proj": dense_init(gen, d_in, d, scale=out_scale, **kw),
    }


def mamba2_state_init(cfg: ModelConfig, batch: int, *, dtype: torch.dtype,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    d_in, P, H, N, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv_dim - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  xBC: (B, S, ch); w: (K, ch).
    Returns (out, new conv state: the last K-1 inputs), summed in the
    reference's order."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros_like(xBC[:, :K - 1])
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)  # (B, S+K-1, ch)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    return out, xp[:, -(K - 1):]


def mamba2_block(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,  # read only
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, new state); the new state is None when ``state`` is."""
    B, S, d = x.shape
    d_in, P, H, N, conv_ch = _dims(cfg)

    zxbcdt = dense(p["in_proj"], x)
    z, xBC, dt_raw = torch.split(zxbcdt, [d_in, conv_ch, H], dim=-1)

    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs, Bmat, Cmat = torch.split(xBC, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)  # a view: each time step's (H, P) block is contiguous

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    a = -torch.exp(p["a_log"])  # (H,)
    decay = torch.exp(dt * a)  # (B, S, H)

    y, h_final = ops.mamba2_ssd_scan(xs, Bmat, Cmat, decay, dt,
                                     state["ssm"] if state is not None else None)
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, d_in).to(x.dtype)

    y = y * F.silu(z.float()).to(x.dtype)
    y = group_norm(y, H) * p["norm_scale"]
    out = dense(p["out_proj"], y)

    new_state = {"conv": new_conv, "ssm": h_final} if state is not None else None
    return out, new_state
