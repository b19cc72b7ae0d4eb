"""Fault-tolerant training runtime: one device, or one rank of a
data-parallel world.

The counterpart of ``repro/runtime/trainer.py``:

  * checkpoint/restart: periodic async checkpoints; ``run()`` survives a
    failed step (``FloatingPointError`` or ``RuntimeError``) by restoring
    the last committed checkpoint and replaying the data pipeline to the
    same batch, at most ``max_restarts`` times;
  * straggler detection: a per-step wall-time EWMA; a step slower than
    ``straggler_factor`` times it fires ``on_straggler``;
  * preemption: SIGTERM sets a flag; the loop checkpoints and stops at the
    next step boundary;
  * elasticity: ``replan(world_size, shard_bytes)`` re-derives the OpTree
    staged all-gather plan for a new device count.

Where the reference jits a step that donates its buffers, ``make_train_step``
returns a step that runs the loss and its backward and then updates the
parameters and the optimizer state in place.  ``make_dp_train_step`` is
the reference's explicit ZeRO-1 step (``repro/launch/train.py``) for one
rank of a data-parallel world, with the OpTree-planned reduce-scatter and
all-gather between the backward and the update; ``Trainer`` runs either.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..comms import api
from ..configs.base import ModelConfig
from ..core.planner import ICI_LINK, plan_staged_allgather
from ..models import loss_fn
from ..models.sharding import dp_axes
from ..optim import OptimizerConfig, adamw_update
from ..optim.zero1 import zero1_shard_grads, zero1_unshard_params
from ..tree import tree_copy_, tree_leaves, tree_map

__all__ = ["TrainerConfig", "Trainer", "make_train_step", "make_dp_train_step", "replan"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_interval: int = 20
    ckpt_dir: str = "build/train_ckpt"
    log_interval: int = 10
    straggler_factor: float = 3.0
    ema_decay: float = 0.9


def _loss_and_grads(cfg: ModelConfig, params, batch):
    """(gradients with the parameters' structure, detached metrics) of
    ``loss_fn`` on ``batch``; the parameters are made to require grad."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, params, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
    return tree_map(lambda _: next(grads), params), {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and its gradient with respect to every parameter, then one
    AdamW step written in place.  ``batch`` holds (B, S) ``labels`` and
    the inputs of ``loss_fn`` (``tokens``, or an audio model's ``embeds``)
    on the parameters' device; the metrics are detached 0-dim
    tensors.  The parameters are made to require grad."""

    def step(params, opt_state, batch):
        grads, metrics = _loss_and_grads(cfg, params, batch)
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, metrics

    return step


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def _reference_layout(tree: Dict) -> Dict:
    """The reference's layout of a parameter-shaped tree: ``layers``
    stacked on a leading axis (a copy) and every dict's keys sorted, the
    order in which jax flattens a tree."""
    out = dict(tree)
    layers = out.pop("layers")
    out["layers"] = tree_map(lambda *xs: torch.stack(xs), layers[0], *layers[1:])
    return _sorted(out)


def _port_layout(ref: Dict, like: Dict) -> Dict:
    """``ref`` (the reference's layout) back in the structure and order of
    ``like``; each layer's leaves are views into the stacked ones."""
    return {k: ([tree_map(lambda _, s, i=i: s[i], layer, ref[k]) for i, layer in enumerate(v)]
                if k == "layers" else tree_map(lambda _, s: s, v, ref[k]))
            for k, v in like.items()}


def make_dp_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, mesh,
                       fast: Sequence[str], slow: Sequence[str] = (),
                       ctx=None) -> Callable:
    """The reference's ZeRO-1 ``explicit_step`` (``repro/launch/train.py``)
    for this rank of a data-parallel world: ``step(params, opt_state,
    batch)`` with the GLOBAL batch on this rank's device.

    This rank keeps its rows (``P(dp_axes(mesh), None)``: block
    ``mesh.axis_index(dp_axes(mesh))``) and takes the loss and gradients
    on them.  The gradients, in the reference's layout (layers stacked),
    are divided by the data-parallel size, reduce-scattered over ``fast``
    with the ``slow`` axes summed on the scattered shard
    (``zero1_shard_grads``) and gathered back (``zero1_unshard_params``),
    all through the context-planned collectives of ``ctx`` (default: the
    context installed when the step runs).  Leaves whose leading dimension
    does not split over ``fast`` are summed over every axis instead, as in
    the reference; the stacked layers are such leaves whenever the layer
    count does not divide.  Every rank then takes the same AdamW step.
    The loss returned is the mean over the world."""
    fast, slow = tuple(fast), tuple(slow)
    ndp = mesh.axis_size(fast + slow)
    block = mesh.axis_index(dp_axes(mesh))

    def step(params, opt_state, batch):
        c = ctx if ctx is not None else api.current_context()
        rows, rest = divmod(batch["labels"].shape[0], ndp)
        if rest:
            raise ValueError(f"a global batch of {batch['labels'].shape[0]} rows does not "
                             f"split over the {ndp} data-parallel ranks")
        local = {k: v[block * rows:(block + 1) * rows] for k, v in batch.items()}
        with api.use_context(c):  # the MoE block's expert all-to-all resolves it
            grads, metrics = _loss_and_grads(cfg, params, local)
            stacked = _reference_layout(grads)
            del grads
            full = tree_map(lambda g: torch.empty(g.shape, device="meta"), stacked)
            stacked = tree_map(lambda g: g.div_(ndp), stacked)
            stacked = zero1_shard_grads(stacked, fast, slow, ctx=c)
            stacked = zero1_unshard_params(stacked, fast, reference=full, ctx=c)
        params, opt_state = adamw_update(_port_layout(stacked, params), opt_state,
                                         params, opt_cfg)
        loss = mesh.psum(metrics["loss"].reshape(1), fast + slow).reshape(()) / ndp
        return params, opt_state, {"loss": loss}

    return step


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: OptimizerConfig,
        tcfg: TrainerConfig,
        *,
        params,
        opt_state,
        pipeline,
        train_step: Optional[Callable] = None,
        fault_injector: Optional[Callable[[int], None]] = None,
        on_step: Optional[Callable[[Dict], None]] = None,
        on_commit: Optional[Callable[[int, Any], None]] = None,
        writer: bool = True,
    ):
        """``on_step(entry)`` is called with each step's ``metrics_log``
        entry, ``on_commit(step, path)`` after each checkpoint commits.
        Only a ``writer`` saves checkpoints (in a data-parallel world, rank
        0; every rank restores), and none is saved when
        ``tcfg.ckpt_interval`` is 0."""
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.params, self.opt_state = params, opt_state
        self.device = tree_leaves(params)[0].device
        self.pipeline = pipeline
        self.train_step = train_step or make_train_step(cfg, opt_cfg)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, on_commit=on_commit)
        self.fault_injector = fault_injector
        self.on_step = on_step
        self.writer = writer and tcfg.ckpt_interval > 0
        self.step = 0
        self.preempted = False
        self.max_restarts = 5
        self.step_time_ema: Optional[float] = None
        self.straggler_events: List[Dict] = []
        self.metrics_log: List[Dict] = []
        self.restarts = 0

    # ---- hooks --------------------------------------------------------
    def install_preemption_handler(self):
        def _handler(signum, frame):
            self.preempted = True

        signal.signal(signal.SIGTERM, _handler)

    def on_straggler(self, step: int, dt: float, ema: float):
        self.straggler_events.append({"step": step, "dt": dt, "ema": ema})

    # ---- checkpoint/restart --------------------------------------------
    def _state(self) -> Dict[str, Any]:
        return {
            "params": self.params,
            "opt_state": self.opt_state,
            "data_state": self.pipeline.state(),
        }

    def save(self, blocking: bool = False):
        if self.writer:
            self.ckpt.save(self.step, self._state(), blocking=blocking)

    def try_restore(self) -> bool:
        """Load the latest committed checkpoint into the parameters and the
        optimizer state (in place) and move the pipeline to its batch."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        step, state = self.ckpt.restore(self._state())
        tree_copy_(self.params, state["params"])
        tree_copy_(self.opt_state, state["opt_state"])
        ds = state["data_state"]
        self.pipeline.restore({k: np.asarray(v).item() for k, v in ds.items()})
        self.step = step
        return True

    # ---- main loop ------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        self.install_preemption_handler()
        while self.step < self.tcfg.total_steps and not self.preempted:
            try:
                batch_np = next(self.pipeline)
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch_np.items()}
                if self.fault_injector is not None:
                    self.fault_injector(self.step)  # may raise
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch
                )
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                if self.step_time_ema is not None and dt > (
                    self.tcfg.straggler_factor * self.step_time_ema
                ):
                    self.on_straggler(self.step, dt, self.step_time_ema)
                d = self.tcfg.ema_decay
                self.step_time_ema = (
                    dt if self.step_time_ema is None
                    else d * self.step_time_ema + (1 - d) * dt
                )
                self.metrics_log.append({"step": self.step, "loss": loss, "dt": dt})
                if self.on_step is not None:
                    self.on_step(self.metrics_log[-1])
                self.step += 1
                if self.tcfg.ckpt_interval and self.step % self.tcfg.ckpt_interval == 0:
                    self.save(blocking=False)
            except (FloatingPointError, RuntimeError) as e:
                # node failure / injected fault: restart from last checkpoint
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts; last error: {e}"
                    ) from e
                if not self.try_restore():
                    self.step = 0
                    self.pipeline.restore({"step": 0, "seed": self.pipeline.cfg.seed})
        self.ckpt.wait()
        self.save(blocking=True)
        return {
            "final_step": self.step,
            "restarts": self.restarts,
            "stragglers": len(self.straggler_events),
            "losses": [m["loss"] for m in self.metrics_log],
        }


def replan(world_size: int, shard_bytes: float):
    """Elastic hook: re-derive the OpTree collective plan for a new world
    size (called when the scheduler grows or shrinks the job)."""
    return plan_staged_allgather(world_size, shard_bytes, ICI_LINK)
