"""RWKV6 "Finch" block (arXiv:2404.05892): data-dependent-decay linear attention.

The counterpart of ``repro/models/rwkv6.py``.  Time-mix: token shift with a
data-dependent low-rank lerp, the WKV6 recurrence (``kernels.ops.rwkv6_scan``:
the CUDA kernel on the card, its plain version on the CPU), a per-head group
norm and a silu gate.  Channel-mix: a shifted squared-relu FFN.

The reference's casts are kept as they are: ``w0`` and ``u`` are f32 leaves;
the decay ``w = exp(-exp(w_log))`` is computed in f32 and cast to r's dtype
before the scan; silu, relu² and sigmoid run in f32 and are cast back.  So
are its layouts: ``mu`` is (5, d), ``lora_b`` (5, 32, d), and r, k, v, w are
(B, H, S, hd) at the scan.

Decode state per layer: ``{"tmix_x": (B, d), "cmix_x": (B, d), "wkv":
(B, H, hd, hd) f32}``, O(1) per token.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense, dense_init, group_norm

__all__ = ["TOKEN_SHIFT_RANK", "DECAY_RANK", "rwkv6_init", "rwkv6_state_init",
           "rwkv6_time_mix", "rwkv6_channel_mix"]

TOKEN_SHIFT_RANK = 32
DECAY_RANK = 64


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
               device: torch.device) -> Dict:
    """The reference's distributions and scales, drawn from ``gen``.  As in
    the reference, which draws both from one key, ``mu_r`` equals ``mu_k``."""
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    H = d // hd
    out_scale = 0.02 / (2 * cfg.num_layers) ** 0.5
    kw = dict(dtype=dtype, device=device)

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device)

    def uniform(*shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=device)

    tmix = {
        "mu": (uniform(5, d) * 0.5 + 0.25).to(dtype),
        "lora_a": (normal(d, 5 * TOKEN_SHIFT_RANK) * 0.01).to(dtype),
        "lora_b": (normal(5, TOKEN_SHIFT_RANK, d) * 0.01).to(dtype),
        "w0": normal(d) * 0.1 - 6.0,  # f32 whatever the model's dtype
        "w_lora_a": (normal(d, DECAY_RANK) * 0.01).to(dtype),
        "w_lora_b": (normal(DECAY_RANK, d) * 0.01).to(dtype),
        "u": normal(H, hd) * 0.1,  # f32 whatever the model's dtype
        "wr": dense_init(gen, d, d, **kw),
        "wk": dense_init(gen, d, d, **kw),
        "wv": dense_init(gen, d, d, **kw),
        "wg": dense_init(gen, d, d, **kw),
        "wo": dense_init(gen, d, d, scale=out_scale, **kw),
    }
    mu_k = (uniform(d) * 0.5 + 0.25).to(dtype)
    cmix = {
        "mu_k": mu_k,
        "mu_r": mu_k.clone(),
        "wk": dense_init(gen, d, cfg.d_ff, **kw),
        "wv": dense_init(gen, cfg.d_ff, d, scale=out_scale, **kw),
        "wr": dense_init(gen, d, d, **kw),
    }
    return {"tmix": tmix, "cmix": cmix}


def rwkv6_state_init(cfg: ModelConfig, batch: int, *, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    H = d // hd
    return {
        "tmix_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "cmix_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    }


def _token_shift(x: torch.Tensor, last_x: Optional[torch.Tensor]) -> torch.Tensor:
    """Previous-token values: (B, S, d) -> (B, S, d); position 0 takes
    ``last_x`` (zeros when None)."""
    prev = torch.zeros_like(x[:, :1]) if last_x is None else last_x[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv6_time_mix(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    last_x: Optional[torch.Tensor] = None,  # (B, d)
    wkv_state: Optional[torch.Tensor] = None,  # (B, H, hd, hd) f32, read only
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new last_x, new wkv state)."""
    B, S, d = x.shape
    hd = cfg.ssm.head_dim
    H = d // hd

    def heads(t: torch.Tensor) -> torch.Tensor:  # (B, S, d) -> contiguous (B, H, S, hd)
        return t.reshape(B, S, H, hd).transpose(1, 2).contiguous()

    xx = _token_shift(x, last_x) - x
    # data-dependent lerp (Finch "ddlerp"): 5 channels r, k, v, g, w
    base = x + xx * p["mu"][0]
    lora = torch.tanh(base @ p["lora_a"]).reshape(B, S, 5, TOKEN_SHIFT_RANK)
    deltas = torch.einsum("bscr,crd->bscd", lora, p["lora_b"])  # (B, S, 5, d)
    mixed = x[:, :, None] + xx[:, :, None] * (p["mu"][None, None] + deltas)
    xr, xk, xv, xg, xw = mixed.unbind(dim=2)

    r = heads(dense(p["wr"], xr))
    k = heads(dense(p["wk"], xk))
    v = heads(dense(p["wv"], xv))
    g = dense(p["wg"], xg)

    # data-dependent decay in (0, 1): w = exp(-exp(w0 + lora(xw))), in f32
    w_log = p["w0"].float() + torch.tanh(xw @ p["w_lora_a"]).float() @ p["w_lora_b"].float()
    w = heads(torch.exp(-torch.exp(w_log)).to(r.dtype))

    y, new_state = ops.rwkv6_scan(r, k, v, w, p["u"], wkv_state)
    y = y.transpose(1, 2).reshape(B, S, d)
    y = group_norm(y, H, eps=64e-5)
    y = y * F.silu(g.float()).to(y.dtype)
    return dense(p["wo"], y), x[:, -1], new_state


def rwkv6_channel_mix(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    last_x: Optional[torch.Tensor] = None,  # (B, d)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, new last_x)."""
    xx = _token_shift(x, last_x) - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = torch.square(torch.relu(dense(p["wk"], xk).float())).to(x.dtype)
    kv = dense(p["wv"], k)
    r = torch.sigmoid(dense(p["wr"], xr).float()).to(x.dtype)
    return r * kv, x[:, -1]
