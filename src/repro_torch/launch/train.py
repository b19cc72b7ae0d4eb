"""Training entry point on one device.

The single-device path of ``repro/launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduced --device cpu --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --seq 1024 --batch 4 --steps 6

Weights are random (``init_params`` with seed 0), batches of tokens and
labels come from ``SyntheticLMPipeline`` (seed 0; a vision model such as
phi-3-vision-4.2b trains on them text-only, as the reference's launcher
runs it; the audio model takes frame embeddings, which the pipeline does
not make, and is refused), and the optimizer is the reference's
AdamW with its warm-up ``min(20, steps // 5 + 1)`` and a cosine decay over
``--steps``.  The steps run through ``runtime.Trainer``: a checkpoint of
the parameters, the optimizer state and the pipeline's position is saved
every ``--ckpt-interval`` steps and after the last (asynchronously; a line
``[train/ckpt] committed step N`` is printed when N steps' state commits),
and ``--resume`` continues from the latest committed one.  Unlike the
reference, a resumed run also moves the data pipeline to the batch of the
step it resumes at, so it trains on the batches an unbroken run would.
It runs on ``cuda`` unless ``--device cpu`` is given.

The reference's mesh, ``--zero1``, ``--fault-*``, ``--verify-collectives``
and ``--expert-parallel`` need the collectives, tensor-parallel and MoE
ports (ROADMAP queue A: A5b, A6, A7, A10) and are not accepted here.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data import DataConfig, SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    shape_help = ("required unless --reduced: the reference's default shape "
                  "(train_4k: seq 4096, batch 256) is sized for a pod and "
                  "does not fit on one card")
    ap.add_argument("--seq", type=int, default=None,
                    help=f"sequence length (64 with --reduced); {shape_help}")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"global batch (4 with --reduced); {shape_help}")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family, in f32")
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore params/opt/data position from the latest "
                         "committed checkpoint in --ckpt-dir and continue "
                         "from there (no-op when the dir is empty)")
    ap.add_argument("--log-every", type=int, default=10, help="step-log interval")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain versions")
    args = ap.parse_args(argv)
    if not args.reduced and (args.seq is None or args.batch is None):
        ap.error(f"--seq and --batch are {shape_help}")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.frontend == "audio":
        raise SystemExit(f"{cfg.name} takes frame embeddings (batch['embeds']); the "
                         f"synthetic pipeline makes token batches")
    if args.reduced:
        cfg = dataclasses.replace(reduce_cfg(cfg), dtype="float32")
    seq = args.seq or 64
    batch = args.batch or 4
    print(f"device={dev} arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"dtype={cfg.dtype} seq={seq} batch={batch}")

    params = init_params(cfg, seed=0, device=dev)
    opt_cfg = OptimizerConfig(warmup_steps=min(20, args.steps // 5 + 1),
                              decay_steps=args.steps)
    pipe = SyntheticLMPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))

    def log_step(entry):
        step = entry["step"]
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {entry['loss']:.4f} ({entry['dt']:.2f}s/step)",
                  flush=True)

    trainer = Trainer(
        cfg, opt_cfg,
        TrainerConfig(total_steps=args.steps, ckpt_interval=args.ckpt_interval,
                      ckpt_dir=args.ckpt_dir),
        params=params, opt_state=adamw_init(params, opt_cfg), pipeline=pipe,
        on_step=log_step,
        on_commit=lambda step, _: print(f"[train/ckpt] committed step {step}", flush=True))
    if args.resume:
        if trainer.try_restore():
            print(f"[train/resume] resumed from step {trainer.step}")
        else:
            print(f"[train/resume] no committed checkpoint in "
                  f"{args.ckpt_dir}; starting fresh")
    start_step = trainer.step

    t0 = time.time()
    pipe.start()
    try:
        losses = trainer.run()["losses"]
    finally:
        pipe.stop()
    if not losses:  # resumed at/past --steps: nothing left to run
        print(f"done: no steps to run (resumed at {start_step} of {args.steps})")
        return float("nan")
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses[-1]


if __name__ == "__main__":
    main()
