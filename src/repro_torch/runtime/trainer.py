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
all-gather between the backward and the update.  ``make_spec_train_step``
is the reference's spec step: parameters, optimizer state and batch are
DTensors placed by the sharding specs (``place_spec_state``), the step is
written in global semantics and DTensor's own collectives carry it.
``Trainer`` runs any of them; with DTensor state every rank gathers each
checkpoint and the writer writes it.
"""
from __future__ import annotations

import math
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
from ..models import sharding as shd
from ..models.sharding import dp_axes
from ..optim import OptimizerConfig, adamw_init, adamw_update, opt_state_specs
from ..optim.zero1 import zero1_shard_grads, zero1_unshard_params
from ..tree import is_dtensor, tree_copy_, tree_leaves, tree_map

__all__ = ["TrainerConfig", "Trainer", "make_train_step", "make_dp_train_step",
           "make_spec_train_step", "place_spec_batch", "place_spec_state", "replan"]


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
        if is_dtensor(loss):  # the gradient of the whole loss, not of a partial sum
            from torch.distributed.tensor import Replicate

            loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
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


def place_spec_state(cfg: ModelConfig, opt_cfg: OptimizerConfig, params, mesh):
    """The spec path's state on the ``DeviceMesh`` ``mesh`` (dims named
    ``data``, ``model`` [, ``pod``]): ``(params, opt_state, stacked)``.

    Every rank passes the same full ``params``.  The parameters are placed
    by ``sanitize_tree(param_specs)``; their layers are stored stacked, as
    the reference stores them (``stacked``, the layer dim never split), and
    ``params["layers"]`` holds views of that storage, one tree a layer.
    The optimizer state has the reference's layout (layers stacked) and
    ZeRO-1 placements (``sanitize_tree(opt_state_specs)``); its ``step``
    stays a host scalar.  Nothing is sent: each rank keeps its shards."""
    pspecs = shd.sanitize_tree(shd.param_specs(cfg, params), params, mesh)
    stacked = dict(params)
    stacked["layers"] = shd.stack_layers(params["layers"])
    stacked_specs = dict(pspecs)
    stacked_specs["layers"] = shd.map_specs(lambda s: shd.P(None, *s), pspecs["layers"][0])
    opt_state = adamw_init(stacked, opt_cfg)
    ospecs = shd.sanitize_tree(
        opt_state_specs(stacked_specs, stacked, mesh, with_master=opt_cfg.use_master),
        opt_state, mesh)
    placed = shd.distribute_tree(stacked, stacked_specs, mesh)
    del stacked
    for k in ("m", "v", "master"):
        if k in opt_state:
            opt_state[k] = shd.distribute_tree(opt_state[k], ospecs[k], mesh)
    out = dict(placed)
    out["layers"] = shd.unstack_layers(placed["layers"], params["layers"])
    return out, opt_state, placed


def place_spec_batch(batch, mesh):
    """The GLOBAL ``batch`` (the same on every rank) as DTensors on
    ``mesh``: placed ``P(dp_axes(mesh), None)`` when the data axes divide
    its rows and replicated otherwise, as the reference's launcher places
    it.  Nothing is sent: each rank keeps its shard."""
    from torch.distributed.tensor import distribute_tensor

    dp = dp_axes(mesh)
    ndp = math.prod(shd.axis_sizes(mesh)[a] for a in dp)
    spec = shd.P(dp, None) if batch["labels"].shape[0] % ndp == 0 else shd.P()
    return {k: distribute_tensor(v, mesh, shd.to_placements(spec, mesh), src_data_rank=None)
            for k, v in batch.items()}


def make_spec_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, mesh, stacked) -> Callable:
    """The reference's spec step (``repro/launch/train.py``, ``--zero1
    spec``) on the ``DeviceMesh`` ``mesh``: ``step(params, opt_state,
    batch)`` with the state of ``place_spec_state`` (``stacked`` its stacked
    parameters) and the GLOBAL batch on every rank.

    The batch is placed by ``place_spec_batch``; the loss and its gradients run in
    global semantics (plain tensors made inside the step, such as the
    positions, count as replicated), the gradients are stacked as the
    reference's are, and AdamW reduce-scatters them to the ZeRO-1 state and
    writes the parameters back at their placements.  The loss returned is
    a plain 0-dim tensor, the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    def step(params, opt_state, batch):
        with implicit_replication():
            grads, metrics = _loss_and_grads(cfg, params, place_spec_batch(batch, mesh))
            grads["layers"] = shd.stack_layers(grads["layers"])
            # the global norm summed layer by layer, in the order one device
            # sums it, over views of the stacked gradients
            per_layer = dict(grads)
            per_layer["layers"] = shd.unstack_layers(grads["layers"], params["layers"])
            adamw_update(grads, opt_state, stacked, opt_cfg, norm_of=per_layer)
        return params, opt_state, {"loss": metrics["loss"].full_tensor()}

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
        if not self.tcfg.ckpt_interval:
            return
        state = self._state()
        if any(is_dtensor(t) for t in tree_leaves(state)):
            # a collective: every rank gathers, the writer writes
            state = tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, state)
        if self.writer:
            self.ckpt.save(self.step, state, blocking=blocking)

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
