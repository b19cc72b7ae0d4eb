"""Staged-collective and tensor-parallel block benchmarks of the port (the
reference's ``launch/perf.py --collectives`` and ``--tp-block``):

  PYTHONPATH=src python -m repro_torch.launch.perf --collectives 2,4 \\
      --sizes-kb 64,1024 --device cpu

spawns one process per rank of the factorized mesh (``prod(factors)``
ranks, rendezvous through a ``FileStore`` in a fresh directory) and, for
each of ag, rs and ar and each size, prints per execution mode (one-shot
stage barriers / chunked wavefront / per-hop ppermute rings / the
perhop-chunked hybrid) the modeled electrical time (LinkSpec alpha and
bandwidth), the modeled optical time (the paper's Eq. 3 on the RWA-lowered
schedule of the same plan) and the measured time, all off the SAME
CollectivePlan object the engine executes, beside the flat one-shot
``torch.distributed`` collective; then the latency-regime rows (the
recursive-doubling exchange chain against the best ring mode, what
``regime="auto"`` planned, its measured time), the crossovers and the cache
counters.  Every mode's output is checked bit for bit against the flat
collective before it is timed.

The measured times are the slowest rank's mean over ``--reps`` calls: on
``--device cpu`` a gloo world on the host CPU, on ``cuda`` (the default) an
NCCL world with one rank per card, refused when the world is larger than
the card count.  The modeled times use the reference's link constants
(``core.planner.ICI_LINK``/``DCN_LINK``: the major axis DCN-class, the rest
ICI), not this machine's, unless ``--links`` gives fitted ones.

  --links fitted.json  a links table (``core.planner.load_links`` format)
                       fed into the comms context, which re-plans
  --order electrical|optical
                       run the cross-world stage-order search per plan
                       (``PlanPolicy.order``) and report both worlds' best
                       order
  --optical-w W        wavelength count of the optical pricer in the order
                       search (default: TERARACK's 64)
  --bench-json PATH    write the sweep as JSON

  PYTHONPATH=src python -m repro_torch.launch.perf --tp-block 2,4 --device cpu

spawns the same world and runs the explicit tensor-parallel transformer
block (``models.model.transformer_block_tp``) on each rank's slice of one
layer, TP (replicated activations, staged all-reduce combines) and SP
(sequence shards, the fused all-gather -> matmul and matmul ->
reduce-scatter), each with the context's collective-matmul fusion forced
on, off and ``"auto"``.  Per variant it prints the plans the context
cached and the collectives one block issued (``ctx.plan_usage()``), the
modeled electrical and optical time of those very plans weighted by their
issue count, the measured time of one block (the slowest rank's mean) against
the unsharded block (``transformer_block_ref`` on the full layer, one
rank), the modes and the cache counters, after checking the explicit block
against the unsharded one (atol 2e-5, the reference's; f32).  The layer is
the reference's ``tp_block_bench`` one (d 8N, N heads, d_ff 16N for N
ranks) with head dim 16, the flash kernel's smallest (the reference's is
8); ``--seq`` and ``--batch`` size the input.

The reference's ``--calibrate``, ``--moe``, ``--faults``, ``--cluster`` and
``--reconfig`` sections and its hill-climb mode are ROADMAP A12.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import List, Optional

from repro_torch.launch.world import WORLD_TIMEOUT_S, run_world

MODES = ("oneshot", "chunked", "perhop", "hybrid")


def _bench_setup(factors, links_path=None, order=None, optical_w=None):
    """Mesh, link table and comms context of the reference's
    ``_bench_setup``, on the current world."""
    from repro_torch.comms import FactorizedMesh
    from repro_torch.comms.api import CommContext, PlanPolicy
    from repro_torch.core.cost_model import TERARACK, derive_wavelengths
    from repro_torch.core.planner import DCN_LINK, ICI_LINK, load_links

    names = [f"s{i}" for i in range(len(factors))]
    n = math.prod(factors)
    mesh = FactorizedMesh(factors, names)
    # one link model for the modeled plans AND the context being measured:
    # the major axis is DCN-class (the pod analogue), the rest ICI, unless
    # a --links file overrides with fitted specs
    link_map = {names[i]: (DCN_LINK if i == 0 and len(factors) > 1 else ICI_LINK)
                for i in range(len(factors))}
    fitted = None
    if links_path:
        fitted = load_links(links_path, fallbacks=link_map,
                            expect_axes=names, allow_missing=True)
    w = optical_w
    notes = []
    if w is None and fitted is not None and order:
        w = derive_wavelengths(fitted)
        notes.append(f"[perf/collectives] derived optical wavelengths w={w} "
                     f"from fitted links (override with --optical-w)")
    optical_sys = dataclasses.replace(
        TERARACK, n_nodes=n, wavelengths=w if w else TERARACK.wavelengths)
    policy = PlanPolicy(order=order, optical=optical_sys) if order else PlanPolicy()
    ctx = CommContext(mesh, tuple(names), links=link_map, policy=policy)
    if fitted is not None:
        ctx.update_links(fitted)
        link_map = ctx.links
        notes.append(f"[perf/collectives] using fitted links from {links_path}: "
                     + " ".join(f"{k}=(B={v.bandwidth_bytes:.3g},a={v.alpha_s:.3g})"
                                for k, v in sorted(fitted.items())))
    return names, n, mesh, link_map, ctx, notes


def _timed(fn, reps, dev):
    """Mean µs of ``reps`` calls after one warm-up, the slowest rank's."""
    import torch
    import torch.distributed as dist

    fn()
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = torch.tensor([(time.perf_counter() - t0) / reps * 1e6], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def collectives_bench(dev, factors, sizes_kb, reps=10, links_path=None, order=None,
                      optical_w=None, bench_json=None) -> None:
    """The reference's ``collectives_bench`` on this rank of the world (rank
    0 prints)."""
    import torch
    import torch.distributed as dist

    from repro_torch.comms import api
    from repro_torch.core.cost_model import TERARACK, plan_exposure, price

    names, n, mesh, link_map, ctx, notes = _bench_setup(
        factors, links_path, order=order, optical_w=optical_w)
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    for line in notes:
        say(line)
    sys_n = dataclasses.replace(
        TERARACK, n_nodes=n,
        wavelengths=optical_w if optical_w else TERARACK.wavelengths)
    where = ("host CPU under gloo" if dev.type == "cpu" else
             f"{torch.cuda.get_device_name(dev)} under NCCL")
    say(f"[perf/collectives] world {n} ranks, mesh {list(factors)}, measured on "
        f"{where}; modeled with the reference's link constants")
    bench_rows = []
    names_t = tuple(names)
    for kb in sizes_kb:
        rows = kb * 256 // n * n  # f32 rows, divisible by the rank count
        x = torch.arange(rows, dtype=torch.float32, device=dev)
        shard_rows = rows // n
        xs = x[rank * shard_rows:(rank + 1) * shard_rows].clone()  # this rank's AG shard
        flat = {
            "ag": lambda: mesh.all_gather(xs, names_t).reshape(-1),
            "rs": lambda: mesh.psum_scatter(x, names_t),
            "ar": lambda: mesh.psum(x, names_t),
        }
        entry = {
            "ag": lambda mode=None: api.all_gather(xs, ctx=ctx, mode=mode),
            "rs": lambda mode=None: api.reduce_scatter(x, ctx=ctx, mode=mode),
            "ar": lambda mode=None: api.all_reduce(x, axis=0, ctx=ctx, mode=mode),
        }
        ag_search = None
        for coll in ("ag", "rs", "ar"):
            fn = entry[coll]
            want = flat[coll]()
            shard = x.numel() * x.element_size() / n
            plan = ctx.plan(coll, shard, shape=tuple(x.shape), dtype=x.dtype,
                            regime="bandwidth")
            auto_plan = ctx.plan(coll, shard, shape=tuple(x.shape), dtype=x.dtype)
            regime = auto_plan.meta.get("regime", "bandwidth")
            if coll == "ag":
                ag_search = auto_plan.meta.get("order_search")
            modeled = {m: price(plan.with_mode(m)).total_s for m in MODES}
            optical_m = {m: price(plan.with_mode(m), TERARACK).total_s for m in MODES}
            optical = price(plan, TERARACK)
            exposed, hidden = plan_exposure(plan)
            measured = {}
            for m in MODES:
                if not _same_bits(fn(m), want):
                    raise RuntimeError(f"{coll} {kb} KiB {m}: rank {rank} differs "
                                       f"from the flat collective")
                measured[m] = _timed(lambda m=m: fn(m), reps, dev)
            flat_us = _timed(flat[coll], reps, dev)
            parts = " ".join(
                f"{m}={modeled[m] * 1e6:.1f}/{optical_m[m] * 1e6:.1f}/{measured[m]:.0f}us"
                for m in MODES)
            srch = plan.meta.get("order_search")
            order_note = ""
            if srch:
                order_note = (
                    f"order[{srch['backend']}]={','.join(srch['order'])} "
                    f"elec_best={','.join(srch['electrical_best_order'])} "
                    f"opt_best={','.join(srch['optical_best_order'])} "
                    f"flipped={srch['flipped']} ")
            say(f"[perf/collectives] {coll} {kb}KB mesh={list(factors)} "
                f"electrical/optical/measured: {parts} "
                f"flat_oneshot={flat_us:.0f}us "
                f"optical={optical.total_s * 1e6:.1f}us@{optical.steps}steps "
                f"chosen={plan.mode} chunks={plan.num_chunks} {order_note}"
                f"stage_modes={list(plan.stage_modes)} "
                f"exposed={sum(exposed) / 2**10:.0f}KB "
                f"hidden={sum(hidden) / 2**10:.0f}KB bit-identical")

            lat_plan = auto_plan if regime == "latency" else None
            if lat_plan is None:
                try:
                    lat_plan = ctx.plan(coll, shard, shape=tuple(x.shape),
                                        dtype=x.dtype, regime="latency")
                except ValueError:
                    lat_plan = None
            lat_row = None
            if lat_plan is not None:
                lat_elec = price(lat_plan).total_s
                lat_opt = price(lat_plan, sys_n)
                if not _same_bits(fn(None), want):
                    raise RuntimeError(f"{coll} {kb} KiB auto: rank {rank} differs "
                                       f"from the flat collective")
                auto_us = _timed(lambda: fn(None), reps, dev)
                ring_best = min(modeled.values())
                lat_row = dict(
                    elec_us=lat_elec * 1e6, opt_us=lat_opt.total_s * 1e6,
                    opt_steps=lat_opt.steps, rounds=len(lat_plan.stages),
                    measured_auto_us=auto_us)
                say(f"[perf/latency] {coll} {kb}KB regime={regime} "
                    f"exchange: elec={lat_elec * 1e6:.1f}us vs "
                    f"ring_best={ring_best * 1e6:.1f}us "
                    f"optical={lat_opt.total_s * 1e6:.1f}us@{lat_opt.steps}steps "
                    f"rounds={len(lat_plan.stages)} "
                    f"measured_auto={auto_us:.0f}us "
                    f"(auto plans the {regime} family at this size)")
            else:
                say(f"[perf/latency] {coll} {kb}KB regime={regime} "
                    f"exchange=n/a (needs power-of-two axis sizes, n >= 2)")
            bench_rows.append(dict(
                collective=coll, kb=kb, shard_bytes=shard, regime=regime,
                modeled_us={m: v * 1e6 for m, v in modeled.items()},
                optical_mode_us={m: v * 1e6 for m, v in optical_m.items()},
                measured_us=measured, flat_oneshot_us=flat_us,
                optical_us=optical.total_s * 1e6,
                optical_steps=optical.steps, latency=lat_row))
        if order and ag_search:
            say(f"[perf/order] {kb}KB ag: electrical-best="
                f"{','.join(ag_search['electrical_best_order'])} "
                f"optical-best={','.join(ag_search['optical_best_order'])} "
                f"winner[{ag_search['backend']}]={','.join(ag_search['order'])} "
                f"({ag_search['electrical_s'] * 1e6:.1f}us elec, "
                f"{ag_search['optical_s'] * 1e6:.1f}us opt"
                f"@{ag_search['optical_steps']}steps) "
                f"flipped={ag_search['flipped']} "
                f"regime={ag_search.get('regime', 'bandwidth')} "
                f"regime_flipped={ag_search.get('regime_flipped', False)}")

    xovers = {c: ctx.latency_crossover(c) for c in ("ag", "rs", "ar")}
    xnote = " ".join(
        f"{c}={'n/a' if b is None else format(b, '.0f') + 'B'}"
        for c, b in xovers.items())
    st = ctx.cache_stats
    say(f"[perf/latency] crossover mesh={list(factors)} {xnote} "
        f"(electrical; smaller payloads plan exchange chains)")
    say(f"[perf/latency] cache: latency_plans={st.latency_plans} "
        f"ring_plans={st.ring_plans} hits={st.hits} misses={st.misses}")
    if bench_json and rank == 0:
        doc = {
            "mesh": list(factors), "axis_names": names,
            "measured_on": where,
            "links": {k: {"name": v.name, "bandwidth_bytes": v.bandwidth_bytes,
                          "alpha_s": v.alpha_s}
                      for k, v in sorted(link_map.items())},
            "optical_w": sys_n.wavelengths, "order": order, "reps": reps,
            "rows": bench_rows, "crossover_bytes": xovers,
            "cache": dataclasses.asdict(st),
        }
        Path(bench_json).write_text(json.dumps(doc, indent=2) + "\n")
        say(f"[perf/latency] wrote {bench_json}")


#: the explicit block against the unsharded one (the reference's atol)
TP_BLOCK_ATOL = 2e-5


def tp_block_bench(dev, factors, reps=5, links_path=None, seq=32, batch=2) -> list:
    """The reference's ``tp_block_bench`` on this rank of the world (rank 0
    prints): the explicit TP and SP block against the unsharded block, with
    modeled electrical and optical times off the SAME CollectivePlan
    objects the context cached while the block ran."""
    import torch

    from repro_torch.comms import api
    from repro_torch.configs import ModelConfig
    from repro_torch.core.cost_model import TERARACK, price
    from repro_torch.models import (
        shard_tp_layer,
        tp_block_specs,
        transformer_block_ref,
        transformer_block_tp,
    )
    from repro_torch.models.model import _layer_init

    names, n, mesh, link_map, _, notes = _bench_setup(factors, links_path)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    for line in notes:
        say(line)
    cfg = ModelConfig(
        name="tp-block-bench", family="dense", dtype="float32", remat=False,
        qkv_bias=False, qk_norm=False, num_layers=2, d_model=8 * n,
        num_heads=n, num_kv_heads=n, head_dim=16, d_ff=16 * n, vocab_size=128)
    gen = torch.Generator(device=dev).manual_seed(0)  # the same layer on every rank
    layer = _layer_init(gen, cfg, dtype=torch.float32, device=dev)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)
    positions = torch.arange(seq, device=dev).expand(batch, seq)
    where = ("host CPU under gloo" if dev.type == "cpu" else
             f"{torch.cuda.get_device_name(dev)} under NCCL")
    say(f"[perf/tp-block] world {n} ranks, mesh {list(factors)}, B {batch} S {seq} "
        f"d {cfg.d_model} heads {cfg.num_heads} d_ff {cfg.d_ff} f32, measured on {where}; "
        f"modeled with the reference's link constants")
    with torch.no_grad():
        ref = transformer_block_ref(layer, cfg, x, positions=positions)
        t_ref = _timed(lambda: transformer_block_ref(layer, cfg, x, positions=positions),
                       reps, dev)
    rows = []
    for sp in (False, True):
        tag = "sp" if sp else "tp"
        x_split, specs = tp_block_specs(layer, sequence_parallel=sp)
        local = shard_tp_layer(layer, specs, mesh, names)
        xl, want = x, ref
        if x_split is not None:
            idx, blk = mesh.axis_index(names), seq // n
            xl = x.narrow(x_split, idx * blk, blk).contiguous()
            want = ref.narrow(x_split, idx * blk, blk)
        for fuse in (True, False, "auto"):
            with api.comm_context(mesh, tuple(names), links=link_map, fuse=fuse) as ctx, \
                    torch.no_grad():
                def block():
                    return transformer_block_tp(local, cfg, xl, positions=positions,
                                                sequence_parallel=sp)
                ok = bool(torch.allclose(block(), want, rtol=0, atol=TP_BLOCK_ATOL))
                # every collective one block issued, off the context's cache,
                # priced from the very objects executed and weighted by how
                # often each deduplicated plan was issued
                usage = ctx.plan_usage()
                issued = sum(c for _, c in usage)
                elec = sum(price(p).total_s * c for p, c in usage)
                opt = sum(price(p, dataclasses.replace(TERARACK, n_nodes=p.n)).total_s * c
                          for p, c in usage)
                t_explicit = _timed(block, reps, dev)
            row = dict(variant=tag, fuse=fuse, plans=len(usage), issued=issued,
                       modeled_elec_us=elec * 1e6, modeled_opt_us=opt * 1e6,
                       measured_tp_us=t_explicit, measured_unsharded_us=t_ref,
                       allclose=ok, cache=dataclasses.asdict(ctx.cache_stats),
                       modes=sorted({p.mode for p, _ in usage}))
            rows.append(row)
            say(f"[perf/tp-block] {tag} fuse={fuse} mesh={list(factors)} B={batch} S={seq} "
                f"d={cfg.d_model}: plans={row['plans']} issued={issued} "
                f"modeled elec={row['modeled_elec_us']:.1f}us "
                f"optical={row['modeled_opt_us']:.1f}us | measured "
                f"explicit={t_explicit:.0f}us unsharded={t_ref:.0f}us "
                f"modes={row['modes']} cache={row['cache']} allclose={ok}")
            if not ok:
                raise RuntimeError(f"tp-block {tag} fuse={fuse}: the explicit block "
                                   f"diverged from the unsharded block")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    section = ap.add_mutually_exclusive_group(required=True)
    section.add_argument("--collectives", metavar="F1,F2,...",
                         help="mesh factors; prod(factors) ranks are spawned")
    section.add_argument("--tp-block", metavar="F1,F2,...",
                         help="mesh factors of the TP block; prod(factors) ranks")
    ap.add_argument("--sizes-kb", default="64,1024")
    ap.add_argument("--seq", type=int, default=32, help="--tp-block: sequence length")
    ap.add_argument("--batch", type=int, default=2, help="--tp-block: batch")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--links", default=None)
    ap.add_argument("--order", choices=("electrical", "optical"), default=None)
    ap.add_argument("--optical-w", type=int, default=None)
    ap.add_argument("--bench-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; NCCL, one rank per card) or cpu (gloo)")
    ap.add_argument("--timeout", type=float, default=WORLD_TIMEOUT_S)
    args = ap.parse_args(argv)
    spec = args.collectives or args.tp_block
    try:
        factors = [int(f) for f in spec.split(",")]
        sizes_kb = [int(s) for s in args.sizes_kb.split(",")]
    except ValueError:
        ap.error(f"wanted comma-separated integers, got {spec!r} "
                 f"and {args.sizes_kb!r}")
    from repro_torch.comms.mesh_utils import check_world_device

    world = math.prod(factors)
    dev = check_world_device(args.device, world)
    if args.collectives:
        target, name = collectives_bench, "perf --collectives"
        kwargs = dict(factors=factors, sizes_kb=sizes_kb, reps=args.reps,
                      links_path=args.links, order=args.order,
                      optical_w=args.optical_w, bench_json=args.bench_json)
    else:
        if args.seq % world:
            ap.error(f"--seq {args.seq} must split over the {world} ranks (SP)")
        target, name = tp_block_bench, "perf --tp-block"
        kwargs = dict(factors=factors, reps=args.reps, links_path=args.links,
                      seq=args.seq, batch=args.batch)
    run_world(world, dev.type, target, kwargs, args.timeout, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
