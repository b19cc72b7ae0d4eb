"""Mixture-of-Experts block: top-k routing with sort-based capacity dispatch.

The counterpart of ``repro/models/moe.py``, step for step.  Dispatch is
scatter/gather based (Megablocks-style), not the GShard one-hot einsum:
tokens are split into G groups, each group's (token, choice) pairs are
sorted by expert id, a pair's rank within its expert's run is its slot, and
the pairs past an expert's capacity C are dropped.  The experts run as
batched products over the dense (G, E, C, d) buffer of every expert, and
the gated rows are added back to their tokens.

Supports:
  * top-1 + always-on shared expert (llama4-scout),
  * top-2 + parallel dense residual FFN (arctic),
  * load-balance + router-z auxiliary losses.

Where a literal translation would change the result:

* the sort is stable (``jnp.argsort`` is; ``torch.argsort`` is not by
  default), so that the tokens kept when an expert overflows are the
  reference's;
* an overflowing pair's slot is C, written into an (E, C + 1, d) buffer
  whose last slot is cut: the reference's ``mode="drop"``.  A clamped slot
  would overwrite a kept token;
* the router's product runs in float64 and is rounded to float32, so that
  no TF32 setting reaches it and the card and the CPU round the same sums
  (one flipped routing decision sends a token to another expert);
* the experts' ``silu(g) * u`` goes through ``kernels.ops.swiglu``: the
  plain version on the CPU, the B2 kernel on the card.

The reference's ``constrain`` sharding hints are not ported (GSPMD
placements are ROADMAP A12).

Expert parallelism: with ``cfg.moe.expert_axis`` set AND that axis in the
active :func:`repro_torch.comms.api.comm_context`'s mesh, each rank owns
E/m experts, and ``_ep_expert_ffn`` ships the dispatch buffer to the expert
owners and the results back through ``api.all_to_all``; the aux losses
become means over the expert axis (``api.all_reduce``, which carries a
gradient).  Routing and capacity stay group-local to each rank's tokens.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..comms import api
from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense_init
from .mlp import ffn_apply, ffn_init

__all__ = ["moe_init", "moe_block"]


def _ep_active(axis_name: str) -> bool:
    """True when the active comm_context's mesh has ``axis_name``: the
    port's counterpart of the reference's ``shard_map`` axis-env test."""
    ctx = api.current_context(None)
    return ctx is not None and ctx.mesh is not None and axis_name in ctx.mesh.shape


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
             device: torch.device) -> Dict:
    e = cfg.moe
    assert e is not None
    d, E, f = cfg.d_model, e.num_experts, e.d_ff_expert
    scale = 0.02 / (2 * cfg.num_layers) ** 0.5

    def stacked(shape, mul):
        return (torch.randn(shape, generator=gen, device=device) * mul).to(dtype)

    p = {
        "router": dense_init(gen, d, E, dtype=torch.float32, device=device, scale=0.01),
        "experts": {"gate": stacked((E, d, f), 0.02), "up": stacked((E, d, f), 0.02),
                    "down": stacked((E, f, d), scale)},
    }
    kw = dict(dtype=dtype, device=device)
    if e.shared_expert:
        p["shared"] = ffn_init(gen, d, f, cfg.num_layers, **kw)
    if e.dense_residual:
        p["dense"] = ffn_init(gen, d, cfg.d_ff, cfg.num_layers, **kw)
    return p


def _router_logits(router: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``dense(router, x)`` (the router has no bias) in f32, its product
    summed in float64."""
    return (x.double() @ router["w"].double()).float()


def _expert_ffn(experts: Dict, xe: torch.Tensor) -> torch.Tensor:
    """(..., E, C, d) -> (..., E, C, d); batched over experts."""
    g = torch.einsum("...ecd,edf->...ecf", xe, experts["gate"])
    u = torch.einsum("...ecd,edf->...ecf", xe, experts["up"])
    h = ops.swiglu(g.contiguous(), u.contiguous())
    return torch.einsum("...ecf,efd->...ecd", h, experts["down"])


def _ep_expert_ffn(experts: Dict, buf: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Expert-parallel (G, E, C, d) -> (G, E, C, d): each rank owns E/m
    contiguous experts along mesh axis ``axis_name``.

    The dispatch buffer's expert dim is owner-major, so one context-planned
    ``api.all_to_all`` ships every rank's per-expert slices to the expert
    owners, the local experts run on the concatenated arrivals, and the
    inverse all-to-all returns the results to the token owners.

    ``experts`` may hold the full (E, ...) stacked weights (replicated: this
    rank's slice is cut here, so gradients land in the right slice) or an
    already-local (E/m, ...) shard."""
    mesh = api.current_context().mesh
    m = mesh.axis_size(axis_name)
    G, E, C, d = buf.shape
    if E % m:
        raise ValueError(
            f"num_experts {E} not divisible by expert axis "
            f"{axis_name!r} size {m}")
    e_loc = E // m
    w_gate, w_up, w_down = experts["gate"], experts["up"], experts["down"]
    if w_gate.shape[0] == E and m > 1:
        lo = mesh.axis_index(axis_name) * e_loc
        w_gate, w_up, w_down = (w[lo:lo + e_loc] for w in (w_gate, w_up, w_down))
    elif w_gate.shape[0] != e_loc:
        raise ValueError(
            f"expert weights have leading dim {w_gate.shape[0]}; expected "
            f"{E} (replicated) or {e_loc} (local shard) for "
            f"{m}-way expert parallelism")

    # (G,E,C,d) -> (E,G,C,d) -> (E·G·C, d): destination block v = the
    # slices for experts [v·e_loc, (v+1)·e_loc), owner-major by experts
    z = buf.transpose(0, 1).reshape(E * G * C, d)
    z = api.all_to_all(z, axes=(axis_name,))
    # received block u = rank u's slices for MY experts
    z = z.reshape(m, e_loc, G, C, d).transpose(0, 1)
    y = _expert_ffn({"gate": w_gate, "up": w_up, "down": w_down},
                    z.reshape(e_loc, m * G * C, d))
    # inverse exchange: results back to the token owners, expert-major
    y = y.reshape(e_loc, m, G, C, d).transpose(0, 1).reshape(E * G * C, d)
    y = api.all_to_all(y, axes=(axis_name,))
    return y.reshape(E, G, C, d).transpose(0, 1)


def _num_groups(T: int, want: int = 32) -> int:
    g = min(want, T)
    while T % g:
        g -= 1
    return g


def _axis_mean(v: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.pmean(v, axis_name)`` of a 0-dim tensor, with its gradient."""
    m = api.current_context().mesh.axis_size(axis_name)
    return api.all_reduce(v.reshape(1), axis=0, axes=(axis_name,)).reshape(()) / m


def moe_block(p: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out, aux_losses).

    Group-local dispatch: tokens are split into G groups; the sort, rank
    and scatter never cross a group boundary.  Under expert parallelism
    (``cfg.moe.expert_axis`` in the active context's mesh) the experts'
    products run on their owners through ``api.all_to_all``, equal in value
    to this block run on each rank's tokens with every expert local."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    K, E = e.top_k, e.num_experts
    G = _num_groups(T)
    Tg = T // G
    C = max(1, math.ceil(K * Tg / E * e.capacity_factor))

    xt = x.reshape(T, d)
    xg = x.reshape(G, Tg, d)
    router_logits = _router_logits(p["router"], xg.float())  # (G, Tg, E)
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)  # (G, Tg, K)
    if K > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # ---- aux losses (Switch-style, over all tokens) ----
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = F.one_hot(expert_ids, E).float().sum(dim=2).mean(dim=(0, 1))
    aux = {
        "load_balance": E * (me * ce).sum(),
        "router_z": (torch.logsumexp(router_logits, dim=-1) ** 2).mean(),
    }

    # ---- group-local sort-based dispatch ----
    flat_ids = expert_ids.reshape(G, Tg * K)
    sorted_ids, order = torch.sort(flat_ids, dim=-1, stable=True)
    run_start = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    pos_in_expert = torch.arange(Tg * K, device=x.device)[None, :] - run_start
    keep = pos_in_expert < C
    pos_c = torch.where(keep, pos_in_expert, C)  # slot C: dropped below
    src_token = order // K  # (G, TgK) indices into the group's tokens

    gathered = torch.gather(xg, 1, src_token[..., None].expand(G, Tg * K, d))
    slot = (sorted_ids * (C + 1) + pos_c)[..., None].expand(G, Tg * K, d)
    buf = x.new_zeros((G, E * (C + 1), d)).scatter(1, slot, gathered)
    buf = buf.view(G, E, C + 1, d)[:, :, :C]  # (G, E, C, d); overflow cut

    if e.expert_axis is not None and _ep_active(e.expert_axis):
        # experts live on the mesh: dispatch/combine cross it through the
        # context-planned all-to-all; aux means become global
        ye = _ep_expert_ffn(p["experts"], buf, e.expert_axis)  # (G, E, C, d)
        aux = {k: _axis_mean(v, e.expert_axis) for k, v in aux.items()}
    else:
        ye = _expert_ffn(p["experts"], buf)  # (G, E, C, d)

    pos_clip = pos_c.clamp(max=C - 1)
    gates_sorted = torch.gather(gate_vals.reshape(G, Tg * K), 1, order)
    g_idx = torch.arange(G, device=x.device)[:, None]
    rows = ye[g_idx, sorted_ids, pos_clip]  # (G, TgK, d)
    rows = rows.masked_fill(~keep[..., None], 0.0)
    contrib = rows * gates_sorted[..., None].to(rows.dtype)
    dst = (src_token + g_idx * Tg).reshape(-1)
    out = x.new_zeros((T, d)).index_add(0, dst, contrib.reshape(G * Tg * K, d))

    if e.shared_expert:
        out = out + ffn_apply(p["shared"], xt)
    if e.dense_residual:
        out = out + ffn_apply(p["dense"], xt)
    return out.reshape(B, S, d), aux
