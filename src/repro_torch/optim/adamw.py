"""AdamW with f32 master weights, global-norm clipping and a cosine schedule.

The counterpart of ``repro/optim/adamw.py`` with the reference's math in
its order: the gradients' global norm in f32, clipped to ``clip_norm``;
the moments in ``state_dtype`` with f32 arithmetic; bias corrections
``1 - b^step``; decoupled weight decay; and, with ``use_master``, the
update made to an f32 master copy that is then rounded to each
parameter's dtype.  It is not ``torch.optim.AdamW``, whose clip, decay and
master handling differ.

Where JAX donates buffers, the port updates in place: ``adamw_update``
writes the parameters, the moments and the master copy under
``torch.no_grad()`` and returns the same containers.  The norm is summed
leaf by leaf in f32, so no f32 copy of the whole gradient tree is made.

ZeRO-1 is the reference's: ``opt_state_specs`` gives the moments and the
master copy a ``data`` sharding on the first unsharded dim that ``data``
divides (``_zero1_spec``).  On DTensors (``launch.train --zero1 spec``)
``adamw_update`` redistributes each gradient to its moment's placements
(a gradient that is a partial sum over the data axes is reduce-scattered
there), keeps ``m``, ``v`` and ``master`` where they are, and writes each
parameter at its own placements (the master copy, rounded to the
parameter's dtype, is gathered back to them), so the next forward sees
what the specs say.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..models.sharding import P, axis_sizes, map_specs
from ..tree import is_dtensor, tree_leaves, tree_map

__all__ = ["OptimizerConfig", "cosine_lr", "adamw_init", "adamw_update", "opt_state_specs"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # bf16 moments and no master copy take AdamW from 12 to 4 bytes a
    # parameter; the math still runs in f32
    state_dtype: str = "float32"
    use_master: bool = True


def cosine_lr(cfg: OptimizerConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``min_lr`` at
    ``decay_steps``; a 0-dim f32 tensor, computed in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any, cfg: Optional[OptimizerConfig] = None) -> Dict[str, Any]:
    """``{"step": 0-dim int32 on the CPU, "m", "v": zeros in state_dtype
    on each parameter's device, "master": f32 copies (with use_master)}``."""
    cfg = cfg or OptimizerConfig()
    sdt = _DTYPES[cfg.state_dtype]

    def zeros(a: torch.Tensor) -> torch.Tensor:
        return torch.zeros(a.shape, dtype=sdt, device=a.device)

    state: Dict[str, Any] = {
        "step": torch.zeros((), dtype=torch.int32),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }
    if cfg.use_master:
        state["master"] = tree_map(lambda a: a.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 cfg: OptimizerConfig, *, norm_of: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step, written in place into ``params`` and ``opt_state``
    (``grads`` has the parameters' structure); returns both.  The global
    norm is summed over the leaves of ``norm_of`` in their order (default
    ``grads``): the spec step passes its gradients per layer, as one device
    has them, while ``grads`` holds them stacked."""
    step = int(opt_state["step"]) + 1
    lr = float(cosine_lr(cfg, step))

    g_leaves = tree_leaves(grads)
    m_leaves = tree_leaves(opt_state["m"])
    placed = is_dtensor(m_leaves[0])
    sq = [g.float().square().sum() for g in tree_leaves(grads if norm_of is None else norm_of)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    if placed:
        total = total.full_tensor()
    gnorm = torch.sqrt(total)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    if placed:
        scale = float(scale)  # a python number mixes with DTensors

    stepf = torch.tensor(step, dtype=torch.float32)
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)

    def upd(w: torch.Tensor, m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        mh = m.float() / b1c
        vh = v.float() / b2c
        w32 = w.float()
        return w32 - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * w32)

    masters = tree_leaves(opt_state["master"]) if cfg.use_master else [None] * len(g_leaves)
    for g, p, m, v, master in zip(g_leaves, tree_leaves(params), m_leaves,
                                  tree_leaves(opt_state["v"]), masters):
        if placed:  # the gradient at its moment's (ZeRO-1) placements
            g = g.redistribute(m.device_mesh, m.placements)
        g32 = g.float() * scale
        m.copy_(cfg.b1 * m.float() + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32)
        del g32
        if master is not None:
            master.copy_(upd(master, m, v))
            new = master
        else:
            new = upd(p.redistribute(m.device_mesh, m.placements) if placed else p, m, v)
        if placed:  # rounded to the parameter's dtype, then gathered to its placements
            new = new.to(p.dtype).redistribute(p.device_mesh, p.placements)
        p.copy_(new)  # rounds to the parameter's dtype
    opt_state["step"].fill_(step)
    return params, opt_state


def _zero1_spec(spec: P, shape: Tuple[int, ...], data_size: int) -> P:
    """Add a 'data' sharding on the first unsharded dim divisible by the
    data-axis size (ZeRO-1); fall back to the param spec."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for p in parts if p is not None
            for a in (p if isinstance(p, tuple) else (p,))}
    if "data" in used:  # already data-sharded (e.g. FSDP params)
        return P(*parts)
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if p is None and dim % data_size == 0 and dim > 0:
            parts[i] = "data"
            return P(*parts)
    return P(*parts)


def opt_state_specs(param_specs, param_shapes, mesh, *, with_master: bool = True):
    """Specs of the optimizer state (ZeRO-1 over 'data'): ``{"step": P(),
    "m", "v"[, "master"]}`` for ``param_specs`` of leaves shaped as
    ``param_shapes`` (tensors or anything with a ``shape``).  The
    reference's layout stacks the layers; so does the spec path's
    optimizer state (``launch.train``)."""
    data_size = axis_sizes(mesh).get("data", 1)
    zero1 = map_specs(lambda s, t: _zero1_spec(s, tuple(t.shape), data_size),
                      param_specs, param_shapes)
    out = {"step": P(), "m": zero1, "v": zero1}
    if with_master:
        out["master"] = zero1
    return out
