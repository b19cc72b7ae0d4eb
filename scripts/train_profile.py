#!/usr/bin/env python3
"""Where one training step of full granite-3-2b goes, on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/train_profile.py [--steps 3] [--out build/train_profile.txt]

The step is ``chip_smoke.py``'s ``[train/granite]`` step: granite-3-2b at
full width and depth, bf16 parameters, f32 master, m and v, per-layer
remat, batch 4, sequence 1024 from ``SyntheticLMPipeline``.  After two
warm-up steps it prints, per step, the wall time of the loss and its
backward and of the AdamW update, each ended by ``torch.cuda.synchronize``;
then it traces one whole step with ``torch.profiler`` and prints the
device time summed over all kernels (its share of the step's wall time is
the device's busy share) and the operators with the most device time.
The full table goes to ``--out``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def device_us(evt) -> float:
    """An event's own device time in microseconds (the attribute's name
    differs between torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3, help="timed steps after 2 warm-up steps")
    ap.add_argument("--out", default=str(ROOT / "build" / "train_profile.txt"))
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import KERNELS, build
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[profile] torch {torch.__version__} | nvidia-smi: {card}")
    build.build_all(list(KERNELS.values()))
    dev = torch.device("cuda:0")
    cfg = get_config("granite-3-2b")
    B, S = 4, 1024
    params = init_params(cfg, seed=0, device=dev)
    opt_cfg = OptimizerConfig(warmup_steps=2, decay_steps=6)
    opt_state = adamw_init(params, opt_cfg)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab_size, S, B))
    step = make_train_step(cfg, opt_cfg)

    def batch():
        return {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}

    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, batch())
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    for i in range(args.steps):
        b = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = loss_fn(cfg, params, b)
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        it = iter(grads)
        adamw_update(tree_map(lambda _: next(it), params), opt_state, params, opt_cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads
        print(f"[profile] step {i}: loss and backward {t1 - t0:.4f} s, AdamW update "
              f"{t2 - t1:.4f} s, loss {float(loss.detach()):.4f}")

    b = batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernel_us = sum(device_us(e) for e in events if e.device_type == cuda)
    op_us = sum(device_us(e) for e in events if e.device_type != cuda)
    busy_us = kernel_us or op_us  # kernels are listed on their own, or only under their ops
    print(f"[profile] traced step: wall {wall:.4f} s (under the profiler), device time summed "
          f"over kernels {kernel_us / 1e6:.4f} s, over operators {op_us / 1e6:.4f} s, "
          f"busy share {busy_us / 1e6 / wall:.3f}")
    ranked = sorted(events, key=device_us, reverse=True)
    for e in ranked[:25]:
        print(f"[profile]   {device_us(e) / 1e3:10.2f} ms device  {e.count:6d} calls  {e.key[:90]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    sort_by = "self_device_time_total" if hasattr(ranked[0], "self_device_time_total") \
        else "self_cuda_time_total"
    out.write_text(f"{card}\n" + events.table(sort_by=sort_by, row_limit=80))
    print(f"[profile] table written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
