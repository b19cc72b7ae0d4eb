"""Fault-tolerant single-device training runtime.

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
parameters and the optimizer state in place.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs.base import ModelConfig
from ..core.planner import ICI_LINK, plan_staged_allgather
from ..models import loss_fn
from ..optim import OptimizerConfig, adamw_update
from ..tree import tree_copy_, tree_leaves, tree_map

__all__ = ["TrainerConfig", "Trainer", "make_train_step", "replan"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_interval: int = 20
    ckpt_dir: str = "build/train_ckpt"
    log_interval: int = 10
    straggler_factor: float = 3.0
    ema_decay: float = 0.9


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and its gradient with respect to every parameter, then one
    AdamW step written in place.  ``batch`` holds (B, S) ``labels`` and
    the inputs of ``loss_fn`` (``tokens``, or an audio model's ``embeds``)
    on the parameters' device; the metrics are detached 0-dim
    tensors.  The parameters are made to require grad."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        params, opt_state = adamw_update(tree_map(lambda _: next(it), params), opt_state,
                                         params, opt_cfg)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

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
    ):
        """``on_step(entry)`` is called with each step's ``metrics_log``
        entry, ``on_commit(step, path)`` after each checkpoint commits."""
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.params, self.opt_state = params, opt_state
        self.device = tree_leaves(params)[0].device
        self.pipeline = pipeline
        self.train_step = train_step or make_train_step(cfg, opt_cfg)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, on_commit=on_commit)
        self.fault_injector = fault_injector
        self.on_step = on_step
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
                if self.step % self.tcfg.ckpt_interval == 0:
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
