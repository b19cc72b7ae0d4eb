"""The port's benchmark sections of the reference's ``launch/perf.py``:
staged collectives, the tensor-parallel and expert-parallel blocks, the
fault, serving-cluster and reconfiguration models, and link calibration.
Each is one flag; exactly one is given.

  PYTHONPATH=src python -m repro_torch.launch.perf --collectives 2,4 \\
      --sizes-kb 64,1024 --device cpu

spawns one process per rank of the factorized mesh (``prod(factors)``
ranks, ``launch/world.py``) and, for each of ag, rs and ar and each size,
prints per execution mode (one-shot stage barriers / chunked wavefront /
per-hop ppermute rings / the perhop-chunked hybrid) the modeled electrical
time (LinkSpec alpha and bandwidth), the modeled optical time (the paper's
Eq. 3 on the RWA-lowered schedule of the same plan) and the measured time,
all off the SAME CollectivePlan object the engine executes, beside the flat
one-shot ``torch.distributed`` collective; then the latency-regime rows
(the recursive-doubling exchange chain against the best ring mode, what
``regime="auto"`` planned, its measured time), the crossovers and the cache
counters.  Every mode's output is checked bit for bit against the flat
collective before it is timed.

  --calibrate          with --collectives: time the flat all-gather over
                       each axis alone across --sizes-kb (two or more) and
                       fit LinkSpec alpha and bandwidth per axis by least
                       squares; printed as JSON and, with --links PATH,
                       written there
  --links fitted.json  a links table (``core.planner.load_links`` format,
                       e.g. a --calibrate output) fed into the comms
                       context, which re-plans
  --order electrical|optical
                       run the cross-world stage-order search per plan
                       (``PlanPolicy.order``) and report both worlds' best
                       order
  --optical-w W        wavelength count of the optical pricer (default:
                       TERARACK's 64)
  --bench-json PATH    write the sweep as JSON

The measured times are the slowest rank's mean over ``--reps`` calls: on
``--device cpu`` a gloo world on the host CPU, on ``cuda`` (the default) an
NCCL world with one rank per card, refused when the world is larger than
the card count.  The modeled times use the reference's link constants
(``core.planner.ICI_LINK``/``DCN_LINK``: the major axis DCN-class, the rest
ICI), not this machine's, unless ``--links`` gives fitted ones.

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
the reference's GSPMD contrast (``gspmd``: ``transformer_block_ref`` on the
layer and input placed by ``tp_block_specs`` as DTensors over the world's
``DeviceMesh``, DTensor's propagation emitting the collectives), the modes
and the cache counters, after checking the explicit block against the
unsharded one (``transformer_block_ref`` on the full layer, one rank; atol
2e-5, the reference's; f32).  The layer is
the reference's ``tp_block_bench`` one (d 8N, N heads, d_ff 16N for N
ranks) with head dim 16, the flash kernel's smallest (the reference's is
8); ``--seq`` and ``--batch`` size the input.

  PYTHONPATH=src python -m repro_torch.launch.perf --moe 2,4 --device cpu

spawns the same world and runs the expert-parallel MoE block of each of
``--moe-archs`` (reduced configs, f32, 2 sequences of 8 tokens a rank):
experts over the last mesh axis, dispatch and combine through the
context-planned ``api.all_to_all``.  It checks the block against the
all-experts-local block on each rank's shard (the reference's atol 2e-5)
and prints the plans one block issued, their modeled electrical and
optical time weighted by issue count, and the measured time of the
expert-parallel block beside the reference's GSPMD contrast (``gspmd``:
the block with every expert replicated and the batch split ``P(names)``,
as DTensors over the world's ``DeviceMesh``).

  PYTHONPATH=src python -m repro_torch.launch.perf --faults 2,4

prices every collective healthy and degraded (both directions of the
major axis at half bandwidth, wavelengths 1 and 3 lost on the minor axis)
in both cost worlds, asserts that no degraded price is below the healthy
one, and prints what a context planning under the faults picks.  It plans
for the mesh without a world and does no device work.

  PYTHONPATH=src python -m repro_torch.launch.perf --cluster

routes the same seeded Poisson and bursty traces through every
``--policies`` policy on a fast and a slow replica in the event-driven
simulator, in both cost worlds, and asserts that every cost-aware policy
beats round-robin on p99 for the Poisson trace; then (unless
``--sim-only``) replays a trace on two live ``BatchedServer`` replicas of
a 32-wide granite-3-2b (2 layers, and 24 with d_ff 512) on ``--device``,
and asserts that greedy beats round-robin on p99 both in the simulator and
in the measurement.

  PYTHONPATH=src python -m repro_torch.launch.perf --reconfig

sweeps the optical fabric's circuit-reconfiguration delay, lets the
stage-order search pick a plan at each point, re-checks ``price ==
simulate`` and the reconfiguration count, asserts that hiding the delay
behind the previous stage never prices worse than exposing it, and
asserts the flip from factored chains to holding one circuit.  Pure
Python, no device.

The device sections (``--collectives``, ``--tp-block``, ``--moe`` and
``--cluster`` without ``--sim-only``) run on ``cuda`` unless ``--device
cpu`` is given, and raise without a card.  Every gate raises; none is
reported and passed over.  The reference's hill-climb mode (``--arch``,
``--shape``, ``--variants``) has no counterpart yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

from repro_torch.launch.world import WORLD_TIMEOUT_S, run_world

MODES = ("oneshot", "chunked", "perhop", "hybrid")
MOE_ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")
POLICIES = ("round-robin", "jsq", "greedy", "max-flow")


def _bench_setup(factors, links_path=None, order=None, optical_w=None, world=True):
    """Mesh, link table and comms context of the reference's
    ``_bench_setup``.  With ``world`` the mesh spans the current
    ``torch.distributed`` world; without it ``mesh`` is None and the context
    plans from the axis sizes alone (no op can run on it)."""
    from repro_torch.comms import FactorizedMesh
    from repro_torch.comms.api import CommContext, PlanPolicy
    from repro_torch.core.cost_model import TERARACK, derive_wavelengths
    from repro_torch.core.planner import DCN_LINK, ICI_LINK, load_links

    names = [f"s{i}" for i in range(len(factors))]
    n = math.prod(factors)
    mesh = FactorizedMesh(factors, names) if world else None
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
    ctx = CommContext(mesh, tuple(names), links=link_map, policy=policy,
                      axis_sizes=None if world else dict(zip(names, factors)))
    if fitted is not None:
        ctx.update_links(fitted)
        link_map = ctx.links
        notes.append(f"[perf/collectives] using fitted links from {links_path}: "
                     + " ".join(f"{k}=(B={v.bandwidth_bytes:.3g},a={v.alpha_s:.3g})"
                                for k, v in sorted(fitted.items())))
    return names, n, mesh, link_map, ctx, notes


def _where(dev) -> str:
    import torch

    return ("host CPU under gloo" if dev.type == "cpu" else
            f"{torch.cuda.get_device_name(dev)} under NCCL")


def _launches() -> str:
    """Each hand-written kernel's launches in this process, as one line."""
    from repro_torch.kernels import KERNELS

    return " ".join(f"{n}={k.launches}" for n, k in KERNELS.items())


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


def _world_mesh(dev, factors, names):
    """The world as a ``DeviceMesh`` with the bench's axis names: the
    GSPMD contrasts' placements."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(math.prod(factors)).reshape(tuple(factors)),
                      mesh_dim_names=tuple(names))


def _placed(t, dmesh, dim):
    """``t`` as a DTensor split on ``dim`` over every mesh dim (the
    reference's spec with the tuple of every axis), or replicated for None."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = [Replicate() if dim is None else Shard(dim % t.dim())] * dmesh.ndim
    return distribute_tensor(t, dmesh, pl, src_data_rank=None)


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
    where = _where(dev)
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
    from torch.distributed.tensor.experimental import implicit_replication

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
    from repro_torch.tree import tree_map

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
    where = _where(dev)
    say(f"[perf/tp-block] world {n} ranks, mesh {list(factors)}, B {batch} S {seq} "
        f"d {cfg.d_model} heads {cfg.num_heads} d_ff {cfg.d_ff} f32, measured on {where}; "
        f"modeled with the reference's link constants")
    with torch.no_grad():
        ref = transformer_block_ref(layer, cfg, x, positions=positions)
    dmesh = _world_mesh(dev, factors, names)
    rows = []
    for sp in (False, True):
        tag = "sp" if sp else "tp"
        x_split, specs = tp_block_specs(layer, sequence_parallel=sp)
        local = shard_tp_layer(layer, specs, mesh, names)
        # the GSPMD contrast: the whole block on the placed layer and input,
        # its output back at the input's placements
        gx = _placed(x, dmesh, x_split)
        glayer = tree_map(lambda leaf, d: _placed(leaf, dmesh, d), layer, specs)

        def gspmd():
            with implicit_replication():
                out = transformer_block_ref(glayer, cfg, gx, positions=positions)
            return out.redistribute(dmesh, gx.placements)

        with torch.no_grad():
            t_gspmd = _timed(gspmd, reps, dev)
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
                       measured_tp_us=t_explicit, measured_gspmd_us=t_gspmd,
                       allclose=ok, cache=dataclasses.asdict(ctx.cache_stats),
                       modes=sorted({p.mode for p, _ in usage}))
            rows.append(row)
            say(f"[perf/tp-block] {tag} fuse={fuse} mesh={list(factors)} B={batch} S={seq} "
                f"d={cfg.d_model}: plans={row['plans']} issued={issued} "
                f"modeled elec={row['modeled_elec_us']:.1f}us "
                f"optical={row['modeled_opt_us']:.1f}us | measured "
                f"explicit={t_explicit:.0f}us gspmd={t_gspmd:.0f}us "
                f"modes={row['modes']} cache={row['cache']} allclose={ok}")
            if not ok:
                raise RuntimeError(f"tp-block {tag} fuse={fuse}: the explicit block "
                                   f"diverged from the unsharded block")
    say(f"[perf/kernels] {_launches()}")
    return rows


#: the expert-parallel block against the all-experts-local one: the
#: reference's ``np.allclose(..., atol=2e-5)``, numpy's default rtol included
MOE_TOL = dict(rtol=1e-5, atol=2e-5)


def _moe_configs(archs, names, factors) -> list:
    """(arch, expert-parallel reduced config) for each of ``archs``, the
    experts over the last mesh axis; refused as the reference refuses an
    expert count the axis does not divide."""
    from repro_torch.configs import expert_parallel, get_config, reduced

    out = []
    for arch in archs:
        cfg = expert_parallel(reduced(get_config(arch)), axis=names[-1])
        if cfg.moe.num_experts % factors[-1]:
            raise SystemExit(
                f"--moe: {arch} reduced num_experts={cfg.moe.num_experts} "
                f"not divisible by expert axis {names[-1]!r} size {factors[-1]}")
        out.append((arch, cfg))
    return out


def moe_block_bench(dev, factors, reps=5, links_path=None, archs=MOE_ARCHS,
                    seq=8) -> list:
    """The reference's ``moe_block_bench`` on this rank of the world (rank 0
    prints): each arch's reduced MoE block with its experts over the last
    mesh axis, against the all-experts-local block on this rank's shard of
    the batch, with modeled electrical and optical times off the plans ONE
    block issued (read before the timed calls: the eager context counts
    every call, the reference's its one trace)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.comms import api
    from repro_torch.core.cost_model import TERARACK, price
    from repro_torch.models.moe import moe_block, moe_init
    from repro_torch.tree import tree_map

    names, n, mesh, link_map, _, notes = _bench_setup(factors, links_path)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    for line in notes:
        say(line)
    per_dev = 2
    say(f"[perf/moe] world {n} ranks, mesh {list(factors)}, experts over {names[-1]!r}, "
        f"B {per_dev} S {seq} a rank, f32, measured on {_where(dev)}; modeled with the "
        f"reference's link constants")
    dmesh = _world_mesh(dev, factors, names)
    rows = []
    for arch, cfg in _moe_configs(archs, names, factors):
        cfg_ref = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, expert_axis=None))
        gen = torch.Generator(device=dev).manual_seed(0)  # the same weights on every rank
        p = moe_init(gen, cfg, dtype=torch.float32, device=dev)
        x = torch.randn((per_dev * n, seq, cfg.d_model), generator=gen, device=dev)
        # this rank's shard of the batch, in the reference's P(names) order
        xl = x[mesh.rank * per_dev:(mesh.rank + 1) * per_dev]

        def local():
            return moe_block(p, cfg_ref, xl)[0]

        def ep():
            return moe_block(p, cfg, xl)[0]

        # the GSPMD contrast: every expert replicated, the batch split P(names)
        gp = tree_map(lambda leaf: _placed(leaf, dmesh, None), p)
        gx = _placed(x, dmesh, 0)

        def gspmd():
            with implicit_replication():
                out = moe_block(gp, cfg_ref, gx)[0]
            return out.redistribute(dmesh, gx.placements)

        with torch.no_grad():
            want = local()
            with api.comm_context(mesh, tuple(names), links=link_map) as ctx:
                close = torch.allclose(ep(), want, **MOE_TOL)
                usage = ctx.plan_usage()
                cache = dataclasses.asdict(ctx.cache_stats)
                t_ep = _timed(ep, reps, dev)
            t_gspmd = _timed(gspmd, reps, dev)
        flag = torch.tensor([int(close)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)  # the check spans every shard
        ok = bool(flag.item())
        a2a = [(pl, c) for pl, c in usage if pl.collective == "a2a"]
        issued = sum(c for _, c in usage)
        elec = sum(price(pl).total_s * c for pl, c in usage)
        opt = sum(price(pl, dataclasses.replace(TERARACK, n_nodes=pl.n)).total_s * c
                  for pl, c in usage)
        row = dict(arch=arch, plans=len(usage), a2a_plans=len(a2a), issued=issued,
                   modeled_elec_us=elec * 1e6, modeled_opt_us=opt * 1e6,
                   measured_ep_us=t_ep, measured_gspmd_us=t_gspmd, allclose=ok,
                   cache=cache, modes=sorted({pl.mode for pl, _ in usage}))
        rows.append(row)
        say(f"[perf/moe] {arch} mesh={list(factors)} ep_axis={names[-1]} "
            f"E={cfg.moe.num_experts} top_k={cfg.moe.top_k}: plans={row['plans']} "
            f"(a2a={row['a2a_plans']}) issued={issued} "
            f"modeled elec={row['modeled_elec_us']:.1f}us optical={row['modeled_opt_us']:.1f}us "
            f"| measured ep={t_ep:.0f}us gspmd={t_gspmd:.0f}us allclose={ok} "
            f"modes={row['modes']} cache={cache}")
        if not ok:
            raise SystemExit(f"--moe {arch}: EP block diverged from "
                             f"the all-experts-local reference")
        if not a2a:
            raise SystemExit(f"--moe {arch}: no a2a plan in the "
                             f"context cache — EP dispatch did not go "
                             f"through api.all_to_all")
    say(f"[perf/kernels] {_launches()}")
    return rows


def faults_bench(factors, sizes_kb, optical_w=None) -> list:
    """The reference's ``faults_bench``: each collective's plan priced
    healthy and under a canonical ``LinkHealth`` (both directions of the
    major axis at half bandwidth, wavelengths 1 and 3 lost on the minor
    axis) in both cost worlds, degraded never below healthy, and the plan a
    context planning under the faults picks.  Planning only: no world, no
    device."""
    from repro_torch.comms.api import CommContext
    from repro_torch.core.cost_model import TERARACK, price
    from repro_torch.core.health import LinkHealth

    names, n, _, link_map, ctx, _ = _bench_setup(factors, optical_w=optical_w, world=False)
    print(f"[perf/faults] modeled prices only, no device work: the mesh {list(factors)} "
          f"is planned from its axis sizes, with no world")
    system = dataclasses.replace(
        TERARACK, n_nodes=n, wavelengths=optical_w if optical_w else TERARACK.wavelengths)
    health = LinkHealth.make(
        # both directions: axis_factor is the best ALIVE direction, so a
        # single-direction derate is invisible to the electrical model
        derate={(names[0], 0): 0.5, (names[0], 1): 0.5},
        lost_wavelengths={names[-1]: (1, 3)},
    )
    faulted = CommContext(None, tuple(names), links=link_map, health=health,
                          axis_sizes=dict(zip(names, factors)))
    print(f"[perf/faults] mesh={list(factors)} health: {health.describe()} "
          f"(fp={faulted.health_fp})")
    rows = []
    for kb in sizes_kb:
        rows_n = kb * 256 // n * n  # f32 rows, divisible by the device count
        shard_bytes = rows_n * 4 / n
        for coll in ("ag", "rs", "ar", "a2a"):
            plan = ctx.plan(coll, shard_bytes)
            e_h = price(plan).total_s
            e_d = price(plan, health=health).total_s
            o_h = price(plan, system)
            o_d = price(plan, system, health=health)
            if e_d < e_h or o_d.total_s < o_h.total_s:
                raise SystemExit(
                    f"--faults: degraded price below healthy for {coll} "
                    f"{kb}KB (elec {e_d} < {e_h} or opt {o_d.total_s} < "
                    f"{o_h.total_s})")
            replanned = faulted.plan(coll, shard_bytes)
            rows.append(dict(collective=coll, kb=kb, elec_healthy_us=e_h * 1e6,
                             elec_degraded_us=e_d * 1e6,
                             opt_healthy_us=o_h.total_s * 1e6,
                             opt_degraded_us=o_d.total_s * 1e6,
                             replanned_mode=replanned.mode))
            print(f"[perf/faults] {coll} {kb}KB "
                  f"elec={e_h * 1e6:.1f}->{e_d * 1e6:.1f}us (x{e_d / e_h:.2f}) "
                  f"optical={o_h.total_s * 1e6:.1f}us@{o_h.steps}"
                  f"->{o_d.total_s * 1e6:.1f}us@{o_d.steps} steps "
                  f"replanned mode={replanned.mode} chunks={replanned.num_chunks}")
    st = faulted.cache_stats
    print(f"[perf/faults] faulted-context cache: misses={st.misses} "
          f"fallbacks={st.fallbacks}")
    return rows


def _tiny_granite(layers, d_ff=64):
    """A measured cluster replica: reduced granite-3-2b at d 32, 2 heads of
    16, vocab 128 (the reference's ``cluster_bench`` replicas)."""
    from repro_torch.configs import get_config, reduced

    return dataclasses.replace(
        reduced(get_config("granite-3-2b")), num_layers=layers, d_model=32,
        num_heads=2, num_kv_heads=2, head_dim=16, d_ff=d_ff, vocab_size=128)


def cluster_measured(policies, *, requests=16, seed=0, device="cuda",
                     clock: Callable[[], float] = time.perf_counter) -> list:
    """Part 2 of :func:`cluster_bench`: two live ``BatchedServer`` replicas
    on ``device`` (2 layers, and 24 with d_ff 512), calibrated by
    ``measure_replica_times``, replay a seeded Poisson trace at a quarter of
    the slow replica's service rate under each policy, beside the
    simulator's replay of the same trace on the calibrated specs.  The
    replay, its pacing and its timestamps run on ``clock``."""
    import numpy as np

    from repro_torch.cluster import (ClusterServer, ClusterSim, ReplicaSpec, Request,
                                     make_policy, measure_replica_times, poisson_trace)
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.runtime import BatchedServer, ServerConfig

    dev = resolve_device(device)
    fast_cfg, slow_cfg = _tiny_granite(2), _tiny_granite(24, d_ff=512)
    fp = init_params(fast_cfg, seed=0, device=dev)
    sp = init_params(slow_cfg, seed=1, device=dev)
    scfg = ServerConfig(batch_size=2, max_seq=64, max_new_tokens=6)
    pf, df = measure_replica_times(fast_cfg, fp, scfg, prompt_tokens=8, warmup=2,
                                   device=dev)
    ps, ds = measure_replica_times(slow_cfg, sp, scfg, prompt_tokens=8, warmup=2,
                                   device=dev)
    print(f"[perf/cluster] calibrated fast step={df * 1e3:.3f}ms "
          f"slow step={ds * 1e3:.3f}ms (x{ds / df:.1f}) on {dev}")
    mspecs = [
        ReplicaSpec.from_times("fast", 2, prefill_token_s=pf, decode_step_s=df),
        ReplicaSpec.from_times("slow", 2, prefill_token_s=ps, decode_step_s=ds),
    ]
    probe = Request(rid=0, arrival_s=0.0, prompt_tokens=8, new_tokens=6)
    rate = 0.25 / mspecs[1].request_service_s(probe)
    trace = poisson_trace(requests, rate_rps=rate, seed=seed,
                          prompt_tokens=(8, 8), new_tokens=(6, 6))
    rows = []
    for pol in policies:
        sim = ClusterSim(mspecs, make_policy(pol)).run(trace)
        servers = [BatchedServer(fast_cfg, fp, scfg, device=dev, clock=clock),
                   BatchedServer(slow_cfg, sp, scfg, device=dev, clock=clock)]
        for srv in servers:  # first calls out of the measured window
            srv.submit(np.arange(8, dtype=np.int32) % 128)
            srv.run_until_drained()
            srv.reset()
        cs = ClusterServer(servers, mspecs, make_policy(pol), clock=clock)
        st = cs.run_trace(trace, prompts=[np.arange(r.prompt_tokens, dtype=np.int32) % 128
                                          for r in trace])
        rows.append(dict(
            policy=pol, sim_p99_ms=sim.latency_p99_s() * 1e3,
            measured_p99_ms=st.latency_p99_s() * 1e3,
            sim_p50_ms=sim.latency_p50_s() * 1e3,
            measured_p50_ms=st.latency_p50_s() * 1e3,
            sim_routed=dict(sim.routed), measured_routed=dict(st.routed)))
        print(f"[perf/cluster] measured {pol:12s} "
              f"sim_p99={sim.latency_p99_s() * 1e3:7.2f}ms "
              f"meas_p99={st.latency_p99_s() * 1e3:7.2f}ms "
              f"sim_routed={dict(sim.routed)} meas_routed={dict(st.routed)}")
    return rows


def cluster_verdicts(policies, measured_rows) -> dict:
    """Each policy against round-robin on p99, simulated and measured; raises
    the reference's error unless greedy beats round-robin in both."""
    mb = {r["policy"]: r for r in measured_rows}
    rr = mb["round-robin"]
    verdicts = {}
    for pol in policies:
        if pol == "round-robin":
            continue
        verdicts[pol] = dict(
            sim_better=mb[pol]["sim_p99_ms"] < rr["sim_p99_ms"],
            measured_better=mb[pol]["measured_p99_ms"] < rr["measured_p99_ms"])
    g = verdicts.get("greedy")
    if g and not (g["sim_better"] and g["measured_better"]):
        raise SystemExit(
            f"--cluster: greedy-vs-round-robin ordering mismatch "
            f"(sim_better={g['sim_better']} "
            f"measured_better={g['measured_better']}) — the simulator's "
            f"prediction no longer matches the measured cluster")
    print("[perf/cluster] measured: policy ordering matches the "
          "simulator's prediction (greedy beats round-robin in both)")
    return verdicts


def cluster_bench(policies=POLICIES, *, requests=16, seed=0, bench_json=None,
                  measured=True, device="cuda") -> dict:
    """The reference's ``cluster_bench``.  Part 1, simulated: every policy
    on the same seeded Poisson and bursty traces (200 rps, 4 x ``requests``
    each) over a fast and a slow replica, in both cost worlds; every
    cost-aware policy must beat round-robin on p99 for the Poisson trace.
    Part 2 (``measured``): :func:`cluster_measured` and the greedy gate of
    :func:`cluster_verdicts`."""
    from repro_torch.cluster import (ClusterSim, ReplicaSpec, bursty_trace, make_policy,
                                     poisson_trace)
    from repro_torch.core.planner import DCN_LINK, ICI_LINK

    policies = list(policies)
    if "round-robin" not in policies:
        policies = ["round-robin"] + policies
    specs = [
        ReplicaSpec.from_times("fast", 4, prefill_token_s=1e-4,
                               decode_step_s=5e-4, link=ICI_LINK),
        ReplicaSpec.from_times("slow", 4, prefill_token_s=4e-4,
                               decode_step_s=2e-3, link=DCN_LINK),
    ]
    traces = {
        "poisson": poisson_trace(requests * 4, rate_rps=200.0, seed=seed),
        "bursty": bursty_trace(requests * 4, rate_rps=200.0, burst=4, seed=seed),
    }
    sim_rows = []
    for world in ("electrical", "optical"):
        for tname, trace in traces.items():
            for pol in policies:
                st = ClusterSim(specs, make_policy(pol), world=world).run(trace)
                sim_rows.append(dict(
                    world=world, trace=tname, policy=pol,
                    p50_ms=st.latency_p50_s() * 1e3,
                    p99_ms=st.latency_p99_s() * 1e3,
                    makespan_ms=st.makespan_s * 1e3,
                    throughput_tok_s=st.throughput_tok_s(),
                    routed=dict(st.routed)))
                print(f"[perf/cluster] sim {world:10s} {tname:7s} "
                      f"{pol:12s} p50={st.latency_p50_s() * 1e3:7.2f}ms "
                      f"p99={st.latency_p99_s() * 1e3:7.2f}ms "
                      f"tput={st.throughput_tok_s():6.0f}tok/s "
                      f"routed={dict(st.routed)}")
    by = {(r["world"], r["trace"], r["policy"]): r for r in sim_rows}
    for world in ("electrical", "optical"):
        rr = by[(world, "poisson", "round-robin")]["p99_ms"]
        for pol in policies:
            if pol in ("round-robin", "jsq"):
                continue
            got = by[(world, "poisson", pol)]["p99_ms"]
            if got >= rr:
                raise SystemExit(
                    f"--cluster: {pol} p99 {got:.2f}ms not better than "
                    f"round-robin {rr:.2f}ms ({world}/poisson) — the cost "
                    f"model stopped paying for itself")
    print("[perf/cluster] sim: cost-model policies beat round-robin p99 "
          "on the poisson trace in both worlds")

    measured_rows, verdicts = [], {}
    if measured:
        measured_rows = cluster_measured(policies, requests=requests, seed=seed,
                                         device=device)
        verdicts = cluster_verdicts(policies, measured_rows)
        print(f"[perf/kernels] {_launches()}")
    doc = dict(requests=requests, seed=seed, policies=policies,
               replicas=[s.name for s in specs],
               simulated=sim_rows, measured=measured_rows,
               ordering_verdicts=verdicts,
               note=("simulated sweep on synthetic calibrated constants in both "
                     "cost worlds; measured rows from 2 live BatchedServer "
                     f"replicas on {device} with wall-clock-paced arrivals "
                     "(underloaded regime: p99 ordering, not absolute times, is "
                     "the validated signal)"))
    if bench_json:
        Path(bench_json).write_text(json.dumps(doc, indent=2) + "\n")
        print(f"[perf/cluster] wrote {bench_json}")
    return doc


def reconfig_bench(n=16, w=2, shard_kb=1024, bench_json=None) -> dict:
    """The reference's ``reconfig_bench``: the circuit-reconfiguration delay
    swept over the single-axis paper-world topology, the stage-order
    search's winner re-checked against the simulator at each point, SWOT
    overlap never pricing worse than the exposed delay, and the flip from a
    reconfiguring chain to holding one circuit.  Pure Python."""
    from repro_torch.core import (
        TERARACK,
        price,
        schedule_from_ir,
        search_stage_orders,
        validate_schedule,
    )
    from repro_torch.core.plan_ir import optical_message_bytes
    from repro_torch.core.planner import ICI_LINK
    from repro_torch.optics import simulate

    axes = [(None, n, ICI_LINK)]
    shard = shard_kb * 1024.0
    rows = []
    for delay in (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2):
        sysd = dataclasses.replace(TERARACK, n_nodes=n, wavelengths=w,
                                   circuit_reconfig_s=delay)
        best = search_stage_orders(axes, shard, collective="ag", backend="optical",
                                   system=sysd).best
        sched = schedule_from_ir(best.plan, sysd.wavelengths)
        validate_schedule(sched)
        rep = simulate(sched, sysd, optical_message_bytes(best.plan))
        if abs(best.optical_s - rep.time_s) > 1e-12 * rep.time_s:
            raise SystemExit(
                f"--reconfig: price != simulate at delay={delay:g} "
                f"({best.optical_s} vs {rep.time_s})")
        if rep.reconfigurations != best.reconfigurations:
            raise SystemExit(
                f"--reconfig: pricer/simulator disagree on event count at "
                f"delay={delay:g} ({best.reconfigurations} vs "
                f"{rep.reconfigurations})")
        # SWOT overlap dominance on the same plan
        t_no = price(best.plan, dataclasses.replace(sysd, reconfig_overlap=False)).total_s
        if best.optical_s > t_no * (1 + 1e-12):
            raise SystemExit(
                f"--reconfig: overlap priced WORSE than exposed at "
                f"delay={delay:g} ({best.optical_s} vs {t_no})")
        factors = [s.factor for s in best.plan.stages]
        rows.append(dict(delay_s=delay, factors=factors,
                         reconfigurations=best.reconfigurations,
                         optical_s=best.optical_s, exposed_s=rep.reconfig_exposed_s,
                         no_overlap_s=t_no))
        print(f"[perf/reconfig] delay={delay:8.2e}s "
              f"best={'x'.join(map(str, factors)):>8s} "
              f"reconfigs={best.reconfigurations} "
              f"t={best.optical_s * 1e3:8.4f}ms "
              f"exposed={rep.reconfig_exposed_s * 1e3:8.4f}ms "
              f"no_overlap={t_no * 1e3:8.4f}ms")
    if rows[0]["reconfigurations"] == 0:
        raise SystemExit("--reconfig: zero-delay winner already holds the "
                         "circuit — no reconfiguring candidate won, the "
                         "flip cannot be demonstrated")
    if rows[-1]["reconfigurations"] != 0:
        raise SystemExit("--reconfig: large-delay winner still pays "
                         f"{rows[-1]['reconfigurations']} reconfigurations "
                         "— the search never flipped to hold-the-circuit")
    flip_at = next(r["delay_s"] for r in rows if r["reconfigurations"] == 0)
    print(f"[perf/reconfig] hold-vs-reconfigure flip: search holds one "
          f"circuit from delay={flip_at:g}s on (n={n}, w={w}, "
          f"shard={shard_kb}KiB)")
    doc = dict(n=n, w=w, shard_kb=shard_kb, rows=rows, flip_at_s=flip_at,
               note=("modeled sweep: search_stage_orders under "
                     "OpticalSystem.circuit_reconfig_s, price==simulate "
                     "re-checked per point, SWOT overlap dominance "
                     "asserted; flip = winner's reconfiguration count "
                     "drops to zero"))
    if bench_json:
        Path(bench_json).write_text(json.dumps(doc, indent=2) + "\n")
        print(f"[perf/reconfig] wrote {bench_json}")
    return doc


def _check_calibration_sizes(sizes_kb) -> None:
    if len(sizes_kb) < 2:
        raise SystemExit("--calibrate needs >= 2 sizes in --sizes-kb to fit "
                         "alpha and bandwidth")


def calibrate_links(dev, factors, sizes_kb, reps=10, links_path=None) -> dict:
    """The reference's ``calibrate_links`` on this rank of the world (rank 0
    prints and writes): for each axis larger than 1, the flat
    ``torch.distributed`` all-gather over that axis's group alone, timed
    across ``sizes_kb``, and the staged model ``t = steps·α + steps·shard/B``
    fitted by least squares, α clipped at 0 and B null where the slope is
    not above 1e-18 s/B (the time did not grow with the payload).  The JSON
    goes to ``links_path`` in the format ``core.planner.load_links``
    reads."""
    import numpy as np
    import torch
    import torch.distributed as dist

    _check_calibration_sizes(sizes_kb)
    names, n, mesh, link_map, _, _ = _bench_setup(factors)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"[perf/calibrate] world {n} ranks, mesh {list(factors)}: the flat all-gather "
        f"over each axis alone, measured on {_where(dev)}")
    fitted = {}
    for name, m in zip(names, factors):
        if m == 1:
            continue
        rows_a, rhs = [], []
        for kb in sizes_kb:
            rows = kb * 256 // m * m
            block = rows // m
            k = mesh.axis_index(name)
            xs = torch.arange(k * block, (k + 1) * block, dtype=torch.float32, device=dev)
            shard = rows * 4 / m
            rows_a.append([m - 1, (m - 1) * shard])
            rhs.append(_timed(lambda: mesh.all_gather(xs, (name,)), reps, dev) * 1e-6)
        sol, *_ = np.linalg.lstsq(np.asarray(rows_a), np.asarray(rhs), rcond=None)
        alpha = max(0.0, float(sol[0]))
        inv_b = float(sol[1])
        bandwidth = (1.0 / inv_b) if inv_b > 1e-18 else None
        fitted[name] = {
            "name": name,
            "bandwidth_bytes": bandwidth,
            "alpha_s": alpha,
            "hardcoded": {
                "bandwidth_bytes": link_map[name].bandwidth_bytes,
                "alpha_s": link_map[name].alpha_s,
            },
        }
        if bandwidth is None:
            fitted[name]["note"] = (
                "no measurable size dependence over this sweep "
                "(alpha-dominated); widen --sizes-kb to identify bandwidth")
    doc = {"mesh": list(factors), "fitted_links": fitted}
    text = json.dumps(doc, indent=2)
    say(text)
    if links_path and mesh.rank == 0:
        Path(links_path).write_text(text + "\n")
        say(f"[perf/calibrate] wrote {links_path} "
            f"(feed back via --collectives --links {links_path})")
    dist.barrier()  # the file is whole before any rank of this world reads it
    return doc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    section = ap.add_mutually_exclusive_group(required=True)
    section.add_argument("--collectives", metavar="F1,F2,...",
                         help="mesh factors; prod(factors) ranks are spawned")
    section.add_argument("--tp-block", metavar="F1,F2,...",
                         help="mesh factors of the TP block; prod(factors) ranks")
    section.add_argument("--moe", metavar="F1,F2,...",
                         help="mesh factors of the expert-parallel MoE block (experts "
                              "over the last axis); prod(factors) ranks")
    section.add_argument("--faults", metavar="F1,F2,...",
                         help="mesh factors of the modeled healthy-vs-degraded prices "
                              "(no world, no device)")
    section.add_argument("--cluster", action="store_true",
                         help="the serving-policy sweep: simulated in both cost worlds, "
                              "then two live replicas on --device")
    section.add_argument("--reconfig", action="store_true",
                         help="the modeled hold-vs-reconfigure sweep (no device)")
    ap.add_argument("--calibrate", action="store_true",
                    help="with --collectives: fit LinkSpec alpha and bandwidth per axis "
                         "(printed as JSON; written to --links PATH)")
    ap.add_argument("--sizes-kb", default="64,1024")
    ap.add_argument("--seq", type=int, default=32, help="--tp-block: sequence length")
    ap.add_argument("--batch", type=int, default=2, help="--tp-block: batch")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--links", default=None)
    ap.add_argument("--order", choices=("electrical", "optical"), default=None)
    ap.add_argument("--optical-w", type=int, default=None)
    ap.add_argument("--bench-json", default=None)
    ap.add_argument("--moe-archs", default=",".join(MOE_ARCHS),
                    help="--moe: comma-separated MoE archs (reduced configs)")
    ap.add_argument("--policies", default=",".join(POLICIES),
                    help="--cluster: comma-separated routing policies")
    ap.add_argument("--cluster-requests", type=int, default=16,
                    help="--cluster: the measured trace's length (the simulated "
                         "traces have 4x this)")
    ap.add_argument("--sim-only", action="store_true",
                    help="--cluster: the simulated sweep alone (no device)")
    ap.add_argument("--seed", type=int, default=0, help="--cluster: trace seed")
    ap.add_argument("--reconfig-n", type=int, default=16,
                    help="--reconfig: node count (one unnamed axis)")
    ap.add_argument("--reconfig-w", type=int, default=2,
                    help="--reconfig: wavelength count")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; NCCL, one rank per card) or cpu (gloo)")
    ap.add_argument("--timeout", type=float, default=WORLD_TIMEOUT_S)
    args = ap.parse_args(argv)
    if args.calibrate and not args.collectives:
        ap.error("--calibrate goes with --collectives")

    if args.reconfig:
        reconfig_bench(n=args.reconfig_n, w=args.reconfig_w, bench_json=args.bench_json)
        return 0
    if args.cluster:
        if not args.sim_only:
            from repro_torch.device import resolve_device

            resolve_device(args.device)  # no card: fail before the simulated part runs
        cluster_bench(args.policies.split(","), requests=args.cluster_requests,
                      seed=args.seed, bench_json=args.bench_json,
                      measured=not args.sim_only, device=args.device)
        return 0
    spec = args.tp_block or args.moe or args.faults or args.collectives
    try:
        factors = [int(f) for f in spec.split(",")]
        sizes_kb = [int(s) for s in args.sizes_kb.split(",")]
    except ValueError:
        ap.error(f"wanted comma-separated integers, got {spec!r} "
                 f"and {args.sizes_kb!r}")
    world = math.prod(factors)
    if args.tp_block:
        if args.seq % world:
            ap.error(f"--seq {args.seq} must split over the {world} ranks (SP)")
        target, name = tp_block_bench, "perf --tp-block"
        kwargs = dict(factors=factors, reps=args.reps, links_path=args.links,
                      seq=args.seq, batch=args.batch)
    elif args.moe:
        archs = args.moe_archs.split(",")
        _moe_configs(archs, [f"s{i}" for i in range(len(factors))], factors)
        target, name = moe_block_bench, "perf --moe"
        kwargs = dict(factors=factors, reps=args.reps, links_path=args.links, archs=archs)
    elif args.faults:
        faults_bench(factors, sizes_kb, optical_w=args.optical_w)
        return 0
    elif args.calibrate:
        _check_calibration_sizes(sizes_kb)
        target, name = calibrate_links, "perf --calibrate"
        kwargs = dict(factors=factors, sizes_kb=sizes_kb, reps=args.reps,
                      links_path=args.links)
    else:
        target, name = collectives_bench, "perf --collectives"
        kwargs = dict(factors=factors, sizes_kb=sizes_kb, reps=args.reps,
                      links_path=args.links, order=args.order,
                      optical_w=args.optical_w, bench_json=args.bench_json)
    from repro_torch.comms.mesh_utils import check_world_device

    dev = check_world_device(args.device, world)
    run_world(world, dev.type, target, kwargs, args.timeout, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
