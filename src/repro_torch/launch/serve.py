"""Serving entry point: batched continuous decode on one device, or a
cluster of replicas behind a routing policy.

The single-server and cluster paths of ``repro/launch/serve.py``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --reduced --device cpu --requests 5
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-scout-17b-a16e --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --reduced --device cpu --replicas 2 --hetero --policy greedy

It serves the dense (granite-3-2b), ssm (rwkv6-7b), hybrid (zamba2-2.7b),
moe (llama4-scout-17b-a16e, arctic-480b) and vlm (phi-3-vision-4.2b, on
text prompts alone, as the reference's server runs it) families; a
full-depth MoE model does not fit one card, and the encoder-only audio
model (hubert-xlarge) has nothing to decode and exits.  Weights are random
(``init_params`` with seed 0, as the reference's ``jax.random.key(0)``;
replica i of a cluster with seed i); prompts are drawn from ``--seed`` with the reference's
lengths (4 to 19 tokens; 8 in a cluster's trace).  It runs on ``cuda``
unless ``--device cpu`` is given, and prints the drain report and how many
times each hand-written kernel was launched.

With ``--replicas N`` it builds N ``BatchedServer`` replicas on the one
device (``--hetero`` makes odd replicas ``--hetero-factor`` times deeper,
the heterogeneous cluster the routing policies exist for), calibrates each
with ``measure_replica_times``, replays the seeded ``--trace`` through the
event-driven simulator and then through the live ``ClusterServer``
(replicas warmed and reset first), and prints the two reports side by side
and as one ``[serve/cluster-json]`` line.  On one device the reference's
decode plans no collectives (its comms report says 0 plans), so there is
no comms report here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.cluster import (ClusterServer, ClusterSim, ReplicaSpec, Request,
                                 make_policy, make_trace, measure_replica_times)
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


def build_cluster(args: argparse.Namespace, cfg) -> Tuple[list, list]:
    """The ``--replicas`` servers on ``args.device`` and their calibrated
    ``ReplicaSpec``s: replica i draws its weights from seed i, odd replicas
    are ``--hetero-factor`` times deeper under ``--hetero`` (named
    ``r<i>-deep``), and each is timed by ``measure_replica_times``."""
    scfg = ServerConfig(batch_size=args.batch_size, max_seq=args.max_seq,
                        max_new_tokens=args.new_tokens)
    servers, specs = [], []
    for i in range(args.replicas):
        deep = args.hetero and i % 2 == 1
        c = dataclasses.replace(cfg, num_layers=cfg.num_layers * args.hetero_factor) \
            if deep else cfg
        params = init_params(c, seed=i, device=args.device)
        pf, ds = measure_replica_times(c, params, scfg, prompt_tokens=8, device=args.device)
        name = f"r{i}" + ("-deep" if deep else "")
        print(f"[serve/cluster] {name}: layers={c.num_layers} "
              f"prefill={pf * 1e3:.3f}ms/tok decode={ds * 1e3:.3f}ms/step", flush=True)
        specs.append(ReplicaSpec.from_times(name, scfg.batch_size, prefill_token_s=pf,
                                            decode_step_s=ds))
        servers.append(BatchedServer(c, params, scfg, device=args.device))
    return servers, specs


def cluster_trace(args: argparse.Namespace) -> List[Request]:
    """The seeded ``--trace`` of ``--requests`` 8-token prompts, each asking
    for ``--new-tokens`` tokens."""
    return make_trace(args.trace, n=args.requests, seed=args.seed, prompt_tokens=(8, 8),
                      new_tokens=(args.new_tokens, args.new_tokens))


def run_cluster(args: argparse.Namespace, servers, specs, trace) -> dict:
    """Replay ``trace`` under ``--policy`` in ``--world``: first through the
    simulator on the calibrated specs, then, after one warm request and a
    ``reset()`` on each replica, through the live ``ClusterServer``.
    Returns both ``ClusterStats``, the simulator's event log, and each
    kernel's launches in the measured replay."""
    sim = ClusterSim(specs, make_policy(args.policy), world=args.world)
    sim_stats = sim.run(trace)
    print(f"[serve/cluster] simulated({args.policy}) {sim_stats.summary()}", flush=True)
    for srv in servers:  # first calls out of the measured window
        srv.submit(np.arange(8, dtype=np.int64) % srv.cfg.vocab_size)
        srv.run_until_drained()
        srv.reset()
    for k in KERNELS.values():
        k.launches = 0
    cluster = ClusterServer(servers, specs, make_policy(args.policy), world=args.world)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, servers[0].cfg.vocab_size, size=r.prompt_tokens)
               for r in trace]
    meas = cluster.run_trace(trace, prompts=prompts)
    launches = {n: k.launches for n, k in KERNELS.items()}
    print(f"[serve/cluster] measured({args.policy})  {meas.summary()}")
    print("[serve/cluster-json] " + json.dumps(
        {"policy": args.policy, "world": args.world, "trace": args.trace,
         "seed": args.seed, "simulated": sim_stats.to_json(),
         "measured": meas.to_json()}, sort_keys=True))
    print("[serve/kernels] " + " ".join(f"{n}={c}" for n, c in launches.items()))
    return {"simulated": sim_stats, "measured": meas, "event_log": list(sim.event_log),
            "results": cluster.results(), "launches": launches}


def serve_cluster(args: argparse.Namespace, cfg) -> dict:
    """``--replicas N``: build and calibrate the replicas, then replay the
    trace through the simulator and the live cluster (``run_cluster``)."""
    servers, specs = build_cluster(args, cfg)
    return run_cluster(args, servers, specs, cluster_trace(args))


def build_parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through N BatchedServer replicas behind "
                         "--policy (1: the single-server path)")
    ap.add_argument("--policy", default="greedy",
                    help="routing policy: round-robin|jsq|greedy|max-flow")
    ap.add_argument("--trace", default="poisson:20",
                    help="arrival trace: poisson:RATE | bursty:RATE[,B] | "
                         "path to a recorded JSON trace")
    ap.add_argument("--world", default="electrical", choices=["electrical", "optical"],
                    help="transmission cost world for routing and simulation")
    ap.add_argument("--hetero", action="store_true",
                    help="make odd replicas deeper (a heterogeneous cluster)")
    ap.add_argument("--hetero-factor", type=int, default=8,
                    help="layer multiplier for deep replicas under --hetero")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduce_cfg(cfg), dtype="float32")
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no autoregressive serve")
    if args.replicas > 1:
        return serve_cluster(args, cfg)
    return serve_single(args, cfg)


if __name__ == "__main__":
    main()
