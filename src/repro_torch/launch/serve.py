"""Serving entry point: batched continuous decode on one device.

The single-server path of ``repro/launch/serve.py``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --reduced --device cpu --requests 5

It serves the dense (granite-3-2b), ssm (rwkv6-7b) and hybrid (zamba2-2.7b)
families.  Weights are random (``init_params`` with seed 0, as the
reference's ``jax.random.key(0)``); prompts are drawn from ``--seed`` with
the reference's lengths (4 to 19 tokens).  It runs on ``cuda`` unless
``--device cpu`` is given, and prints the drain report and how many times
each hand-written kernel was launched.  The multi-replica cluster mode
(``--replicas``) is not ported yet (ROADMAP A11); on one device the
reference's decode plans no collectives, so there is no comms report.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.kernels import KERNELS
from repro_torch.models import init_params
from repro_torch.runtime import BatchedServer, ServerConfig


def serve_single(args: argparse.Namespace, cfg) -> dict:
    params = init_params(cfg, seed=0, device=args.device)
    server = BatchedServer(cfg, params, ServerConfig(
        batch_size=args.batch_size, max_seq=args.max_seq,
        max_new_tokens=args.new_tokens), device=args.device)
    for k in KERNELS.values():
        k.launches = 0
    rng = np.random.default_rng(args.seed)
    rids = [server.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 20))))
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    results = server.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    print(f"served {len(rids)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {server.device}")
    rep = server.drain_report()
    print(f"[serve/drain] requests={rep['requests']} tokens={rep['tokens']} "
          f"p50={rep['latency_p50_s'] * 1e3:.2f}ms "
          f"p99={rep['latency_p99_s'] * 1e3:.2f}ms "
          f"ttft_p50={rep['ttft_p50_s'] * 1e3:.2f}ms")
    for r in rep["per_request"]:
        print(f"[serve/drain]   rid={r['rid']} prompt={r['prompt_tokens']} "
              f"gen={r['generated']}")
    print("[serve/kernels] " + " ".join(f"{n}={k.launches}" for n, k in KERNELS.items()))
    return rep


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain versions")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduce_cfg(cfg), dtype="float32")
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no autoregressive serve")
    return serve_single(args, cfg)


if __name__ == "__main__":
    main()
