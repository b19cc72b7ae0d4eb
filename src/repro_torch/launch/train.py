"""Training entry point: one device, or a data-parallel world.

The port of ``repro/launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduced --device cpu --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --seq 1024 --batch 4 --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduced --device cpu --mesh 2,4,1 --zero1 explicit --steps 3

Weights are random (``init_params`` with seed 0), batches of tokens and
labels come from ``SyntheticLMPipeline`` (seed 0; a vision model such as
phi-3-vision-4.2b trains on them text-only, as the reference's launcher
runs it; the audio model takes frame embeddings, which the pipeline does
not make, and is refused), and the optimizer is the reference's
AdamW with its warm-up ``min(20, steps // 5 + 1)`` and a cosine decay over
``--steps``.  The steps run through ``runtime.Trainer``: a checkpoint of
the parameters, the optimizer state and the pipeline's position is saved
every ``--ckpt-interval`` steps and after the last (asynchronously; a line
``[train/ckpt] committed step N`` is printed when N steps' state commits;
``--ckpt-interval 0`` saves none), and ``--resume`` continues from the
latest committed one.  Unlike the reference, a resumed run also moves the
data pipeline to the batch of the step it resumes at, so it trains on the
batches an unbroken run would.  It runs on ``cuda`` unless ``--device cpu``
is given.

``--mesh data,model`` or ``--mesh pod,data,model`` with ``--zero1
explicit`` trains data-parallel, the reference's explicit ZeRO-1 path: it
spawns ``prod(mesh)`` ranks (``launch.world.run_world``: NCCL, one rank a
card, on ``cuda``; gloo on ``--device cpu``), each with the whole model,
and every step runs ``runtime.make_dp_train_step``: the loss and gradients
on this rank's rows of the global batch, the gradients divided by the
data-parallel size, reduce-scattered over ``data`` with ``pod`` summed on
the scattered shard, all-gathered back, and one AdamW step on every rank.
The collectives are planned by one ``CommContext`` over ``data`` (with
``--verify-collectives``, ``PlanPolicy(verify=True)``); ``--fault-step``
reports a derated link on ``--fault-axis`` to it before that step, and
``--expert-parallel`` shards an MoE model's experts over ``data``.  Rank 0
alone prints and writes checkpoints; every rank restores the same one.  It
prints the ``[train/zero1-explicit]`` pod-traffic note, the
``[train/comms]`` plan telemetry at every log step and at the end, a
``[train/fault]`` line and the final ``[train/comms-json]`` snapshot, as
the reference does.  Both paths end with a ``[train/summary]`` JSON line:
the losses, the step times, the peak device memory and the kernel
launches of the run.  On one card the data-parallel path is ``--mesh 1,1``.

Where the port differs from the reference by design:

* The reference issues its plans once, when ``jax.jit`` traces the step;
  the port runs eagerly and asks its context for every collective of
  every step, so ``issued=`` and the cache ``hits`` count every step.  The
  plans themselves (collective, shard bytes, regime, mode, chunks, stage
  order), the health fingerprint and ``replans_on_fault`` are the
  reference's.
* After ``--fault-step`` the reference's compiled step keeps the schedule
  it was traced with, while the port's next step runs the re-planned one.
  Both schedules compute the same sums, so the losses agree.
* The reference cannot count a verified collective's fallback inside
  ``shard_map`` and prints ``fallbacks=0``; the port counts each one.  On
  float gradients most verified calls fall back to the one-shot
  collective, as the checksums are compared exactly in both packages.
* ``--zero1 spec`` under ``--mesh`` (GSPMD placements by sharding specs)
  waits for DTensor placements (ROADMAP A12c) and is refused;
  ``--zero1 explicit`` needs ``--mesh``.  As in the reference,
  ``--verify-collectives`` without ``--zero1 explicit`` changes nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from types import SimpleNamespace
from typing import Callable, List, Optional

from repro_torch.configs import expert_parallel, get_config, reduced as reduce_cfg
from repro_torch.data import DataConfig, SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.sharding import dp_axes
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.runtime.trainer import Trainer, TrainerConfig, make_dp_train_step

SHAPE_HELP = ("required unless --reduced: the reference's default shape "
              "(train_4k: seq 4096, batch 256) is sized for a pod and "
              "does not fit on one card")


def comm_plan_telemetry(ctx) -> list:
    """Per-plan telemetry lines for one CommContext: the cache counters
    (hits / misses / invalidated) and, per cached CollectivePlan, the
    collective, payload, chosen execution mode/chunks, the stage order it
    executes, how often it was issued, and — when the policy ran the
    cross-world order search — which backend picked the order and whether
    it flipped vs the other world.  Emitted every ``--log-every`` steps by
    the explicit train loop (not just at exit), so a mid-run links update
    (auto-calibration) is visible as invalidations + re-planned orders."""
    snap = ctx.telemetry_snapshot()
    st = snap["cache"]
    lines = [f"comm plans={snap['plans']} hits={st['hits']} "
             f"misses={st['misses']} invalidated={st['invalidated']} "
             f"replans_on_fault={st['replans_on_fault']} "
             f"fallbacks={st['fallbacks']} "
             f"latency_plans={st['latency_plans']} "
             f"ring_plans={st['ring_plans']} "
             f"health={snap['health_fp']}"]
    if ctx.axis_names:
        xover = snap["crossover_ar_bytes"]
        lines.append(
            f"  regime crossover(ar): "
            f"{'n/a' if xover is None else format(xover, '.0f') + 'B'} — "
            f"payloads below it plan recursive-doubling exchange chains")
    for rec in snap["per_plan"]:
        order = ",".join(rec["order"])
        line = (f"  {rec['collective']} "
                f"shard={rec['shard_bytes'] / 2**10:.1f}KiB "
                f"regime={rec['regime']} "
                f"mode={rec['mode']} chunks={rec['num_chunks']} "
                f"order=[{order}] issued=x{rec['issued']}")
        srch = rec.get("order_search")
        if srch:
            line += (f" picked_by={srch['backend']}"
                     f" flipped={srch['flipped']}"
                     f" regime_flipped={srch['regime_flipped']}"
                     f" reconfigs={srch.get('reconfigurations', 0)}")
        if rec.get("fallback"):
            line += " degraded=oneshot-fallback"
        lines.append(line)
    return lines


def modeled_pod_traffic_note(grad_bytes: float, mesh) -> str:
    """Modeled per-device pod(DCN)-axis gradient-sync traffic per step.

    Spec-based path: GSPMD's flat all-reduce over all data axes moves the
    full gradient over every axis, pod included — 2·G·(pod-1)/pod per device
    (RS+AG halves of the ring).  Explicit ZeRO-1 path
    (``zero1_shard_grads``): the pod axis is reduced on the already
    data-scattered shard, so it carries only G/data of that.
    """
    pod = mesh.shape.get("pod", 1)
    if pod == 1:
        return "pod-axis traffic: n/a (no pod axis in this mesh)"
    data = mesh.shape["data"]
    spec_mb = 2 * grad_bytes * (pod - 1) / pod / 2**20
    expl_mb = spec_mb / data
    return (f"modeled pod-axis traffic/device: spec={spec_mb:.2f}MiB/step "
            f"explicit={expl_mb:.2f}MiB/step ({data:.0f}x less: pod reduces "
            f"the data-scattered shard)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default=None,
                    help="data,model or pod,data,model axis sizes: train "
                         "data-parallel over prod(mesh) ranks (needs --zero1 "
                         "explicit and a model axis of 1); one device without")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None,
                    help=f"sequence length (64 with --reduced); {SHAPE_HELP}")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"global batch (4 with --reduced); {SHAPE_HELP}")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family, in f32")
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=50,
                    help="steps between checkpoints; 0 saves none")
    ap.add_argument("--resume", action="store_true",
                    help="restore params/opt/data position from the latest "
                         "committed checkpoint in --ckpt-dir and continue "
                         "from there (no-op when the dir is empty)")
    ap.add_argument("--fault-step", type=int, default=None,
                    help="chaos hook: at this step, report a link fault to "
                         "the comm context (needs --zero1 explicit); the "
                         "context re-plans its cached collectives in place "
                         "under the degraded world")
    ap.add_argument("--fault-axis", default="data",
                    help="mesh axis the injected fault degrades")
    ap.add_argument("--fault-derate", type=float, default=0.5,
                    help="surviving bandwidth fraction for --fault-step")
    ap.add_argument("--verify-collectives", action="store_true",
                    help="run explicit collectives through the verified "
                         "executor (per-stage checksums + bounded retry + "
                         "one-shot fallback; needs --zero1 explicit)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="step-log interval; with --zero1 explicit each log "
                         "also prints the comm context's per-plan telemetry "
                         "(cache stats + chosen order per plan)")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="MoE archs: shard the experts over the 'data' mesh "
                         "axis and route dispatch/combine through the "
                         "context-planned api.all_to_all (needs --zero1 "
                         "explicit); the a2a plans show up in the per-plan "
                         "comm telemetry")
    ap.add_argument("--zero1", choices=["spec", "explicit"], default="spec",
                    help="gradient sync under --mesh: 'explicit' runs the "
                         "staged ZeRO-1 path (reduce-scatter over data, pod "
                         "reduced on the scattered shard, staged re-gather); "
                         "'spec' (GSPMD placements) is ROADMAP A12c")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; under --mesh an NCCL rank a card) or "
                         "cpu (the plain versions; under --mesh a gloo world)")
    return ap


def _mesh_axes(spec: str, ap: argparse.ArgumentParser):
    """(sizes, names) of ``--mesh``: data,model or pod,data,model."""
    try:
        dims = tuple(int(x) for x in spec.split(","))
    except ValueError:
        ap.error(f"--mesh wants comma-separated integers, got {spec!r}")
    if len(dims) not in (2, 3):
        ap.error(f"--mesh takes data,model or pod,data,model, got {spec!r}")
    return dims, (("data", "model") if len(dims) == 2 else ("pod", "data", "model"))


def _config(args, ap: argparse.ArgumentParser):
    """(cfg, seq, batch) of the arguments, refusing what the reference
    refuses, in its words, and what the port cannot run yet."""
    if not args.reduced and (args.seq is None or args.batch is None):
        ap.error(f"--seq and --batch are {SHAPE_HELP}")
    cfg = get_config(args.arch)
    if cfg.frontend == "audio":
        raise SystemExit(f"{cfg.name} takes frame embeddings (batch['embeds']); the "
                         f"synthetic pipeline makes token batches")
    if args.reduced:
        cfg = dataclasses.replace(reduce_cfg(cfg), dtype="float32")
    explicit = args.zero1 == "explicit"
    if args.expert_parallel:
        if not explicit:
            raise SystemExit("--expert-parallel needs --zero1 explicit: the "
                             "EP all-to-all only runs inside the shard_map "
                             "train step where the expert axis is bound")
        cfg = expert_parallel(cfg, axis="data")  # raises if arch has no MoE
    seq = args.seq or 64
    batch = args.batch or 4
    if args.mesh is not None:
        dims, names = _mesh_axes(args.mesh, ap)
        shape = dict(zip(names, dims))
        if not explicit:
            raise SystemExit("--zero1 spec under --mesh places parameters and "
                             "optimizer state by GSPMD sharding specs, which the "
                             "port has not got yet (DTensor placements, ROADMAP "
                             "A12c); use --zero1 explicit")
        if shape["model"] != 1:
            raise SystemExit("--zero1 explicit is the pure-DP shard_map path; "
                             "use a mesh with model axis 1")
        dp = dp_axes(SimpleNamespace(shape=shape))
        if batch % math.prod(shape[a] for a in dp):
            raise SystemExit(f"--zero1 explicit needs batch {batch} divisible "
                             f"by the data axes {dp}")
    elif explicit:
        raise SystemExit("--zero1 explicit trains a data-parallel world; give it "
                         "--mesh (on one card, --mesh 1,1)")
    if args.fault_step is not None and not explicit:
        raise SystemExit("--fault-step reports into the comm context; it "
                         "needs --zero1 explicit")
    return cfg, seq, batch


def train(dev, args, ap: Optional[argparse.ArgumentParser] = None,
          init: Optional[Callable] = None) -> Trainer:
    """Run the training the arguments describe on ``dev``, in this process:
    the whole run on one device, or, under ``--mesh``, this rank's part of
    it (the caller has joined the world).  ``init(cfg, dev)`` gives the
    initial parameters (default: ``init_params`` with seed 0).  Returns
    the trainer after its last step."""
    import torch

    from repro_torch.comms import FactorizedMesh
    from repro_torch.comms.api import CommContext, PlanPolicy
    from repro_torch.kernels import KERNELS
    from repro_torch.tree import tree_leaves

    ap = ap or build_parser()
    cfg, seq, batch = _config(args, ap)
    mesh = ctx = None
    rank0 = True
    if args.mesh is not None:
        mesh = FactorizedMesh(*_mesh_axes(args.mesh, ap))
        rank0 = mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    say(f"device={dev} arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
        f"dtype={cfg.dtype} seq={seq} batch={batch}", flush=True)

    params = (init or (lambda c, d: init_params(c, seed=0, device=d)))(cfg, dev)
    opt_cfg = OptimizerConfig(warmup_steps=min(20, args.steps // 5 + 1),
                              decay_steps=args.steps)
    pipe = SyntheticLMPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    step_fn = traffic_note = None
    if mesh is not None:
        say(f"mesh={dict(mesh.shape)} ranks={mesh.size} backend="
            f"{'nccl' if dev.type == 'cuda' else 'gloo'}", flush=True)
        fast = ("data",)
        slow = ("pod",) if "pod" in mesh.shape else ()
        # one context for every explicit collective (the step installs it
        # while it runs): plans are cached here, and a reported fault
        # re-plans them in place
        ctx = CommContext(mesh, fast, policy=PlanPolicy(verify=args.verify_collectives))
        step_fn = make_dp_train_step(cfg, opt_cfg, mesh, fast, slow, ctx=ctx)
        grad_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
        traffic_note = modeled_pod_traffic_note(grad_bytes, mesh)
        say(f"[train/zero1-explicit] {traffic_note}", flush=True)

    def log_step(entry):
        step = entry["step"]
        if step % args.log_every == 0 or step == args.steps - 1:
            extra = f" [{traffic_note}]" if traffic_note else ""
            say(f"step {step:5d} loss {entry['loss']:.4f} ({entry['dt']:.2f}s/step){extra}",
                flush=True)
            if ctx is not None:
                for line in comm_plan_telemetry(ctx):
                    say(f"[train/comms] {line}", flush=True)

    def report_fault(step):
        if step == args.fault_step:
            ctx.report_fault(axis=args.fault_axis, derate=args.fault_derate)
            st = ctx.cache_stats
            say(f"[train/fault] step {step}: derate "
                f"{args.fault_derate} on axis {args.fault_axis!r} -> "
                f"health={ctx.health_fp} "
                f"replans_on_fault={st.replans_on_fault} "
                f"fallbacks={st.fallbacks}", flush=True)

    trainer = Trainer(
        cfg, opt_cfg,
        TrainerConfig(total_steps=args.steps, ckpt_interval=args.ckpt_interval,
                      ckpt_dir=args.ckpt_dir),
        params=params, opt_state=adamw_init(params, opt_cfg), pipeline=pipe,
        train_step=step_fn,
        fault_injector=report_fault if ctx is not None and args.fault_step is not None
        else None,
        on_step=log_step, writer=rank0,
        on_commit=lambda step, _: say(f"[train/ckpt] committed step {step}", flush=True))
    if mesh is not None:
        trainer.max_restarts = 0  # a rank that restarted alone would hang the rest
    if args.resume:
        if trainer.try_restore():
            say(f"[train/resume] resumed from step {trainer.step}")
        else:
            say(f"[train/resume] no committed checkpoint in "
                f"{args.ckpt_dir}; starting fresh")
    start_step = trainer.step

    for kern in KERNELS.values():
        kern.launches = 0
    pipe.start()
    try:
        losses = trainer.run()["losses"]
    finally:
        pipe.stop()
    launches = {name: k.launches for name, k in KERNELS.items()}
    if ctx is not None:
        say("[train/zero1-explicit] final comm telemetry:")
        for line in comm_plan_telemetry(ctx):
            say(f"[train/comms] {line}")
        say("[train/comms-json] " + json.dumps(ctx.telemetry_snapshot(), sort_keys=True))
    step_s = [m["dt"] for m in trainer.metrics_log]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    say("[train/summary] " + json.dumps({
        "losses": losses, "step_s": step_s, "peak_bytes": peak, "launches": launches,
        "ranks": mesh.size if mesh is not None else 1}))
    if not losses:  # resumed at/past --steps: nothing left to run
        say(f"done: no steps to run (resumed at {start_step} of {args.steps})")
    else:
        say(f"done: {args.steps} steps in {sum(step_s):.1f}s; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    sys.stdout.flush()
    return trainer


def _rank(dev, argv: List[str]) -> float:
    """One rank of ``--mesh``: this rank's part of the run; rank 0's last
    loss comes back to ``main``."""
    log = train(dev, build_parser().parse_args(argv)).metrics_log
    return log[-1]["loss"] if log else float("nan")


def main(argv: Optional[List[str]] = None) -> float:
    """Run the command line; returns the last step's loss (nan when a
    resumed run had no step left)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_parser()
    args = ap.parse_args(argv)
    _config(args, ap)  # refuse before any rank starts
    if args.mesh is None:
        log = train(resolve_device(args.device), args, ap).metrics_log
        return log[-1]["loss"] if log else float("nan")
    from repro_torch.comms.mesh_utils import check_world_device
    from repro_torch.launch.world import run_world

    world = math.prod(_mesh_axes(args.mesh, ap)[0])
    dev = check_world_device(args.device, world)
    return run_world(world, dev.type, _rank, {"argv": argv}, name="train --mesh")


if __name__ == "__main__":
    main()
