#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it
fails:

1. build: every kernel of the serving paths from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` for sm_90a (one process per source, started
   together); prints each kernel's ``-Xptxas -v`` register, shared-memory
   and spill lines;
2. check: each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes, in bf16 and f32, within the
   tolerances in ``TOL`` (rmsnorm, SwiGLU and causal flash attention at the
   training step's B 4, S 1024 among them)
   (``[check/wkv6]``: B 4, H 64, hd 64, S in 1, 37, 65, 128, 200 and 512,
   from a non-zero random state, with the decay drawn by the model's
   formula; ``[check/mamba2_ssd]``: B 4, H 80, P 64, N 64, S in 1, 37, 63,
   64, 65, 128, 129, 200 and 512, from a non-zero state and, at S 1 and
   200, from none (zeros), at S 1, 65 and 200 with decays of exactly 0 and
   1, x, B and C as views of one buffer as the model hands them in, once at
   an odd element offset; each line names the kernel the entry chose
   (``route=decode``, ``chunked`` or ``sequential``), the run fails unless
   all three were checked, and the chunked route is held to the plain
   version of the chunk form as well; flash attention at
   zamba2's head dim 80 too, causal at the serves' prompt lengths 71 and
   445 and at 1, 15 and 64, at granite's GQA rep 4, at hd 128, and at
   llama4-scout's prefill, H 40, Hkv 8 (GQA rep 5), hd 128, S 445, 71 and
   128, at phi-3-vision's prefill, H = Hkv 32, hd 96, causal, S 71, 445,
   576, 1024, 1 and 15, and at hubert-xlarge's encoder, H = Hkv 16, hd 80,
   non-causal, S = T 1024 and 781; ``[check/swiglu]`` at llama4-scout's
   routed-expert buffers (G, 16, C, 8192) of a decode and of the 445-token
   prefill; ``[check/rmsnorm]`` at d 2048, 2560, 4096, 5120, 3072, 1280,
   128 and 100, at 4 and 1780 rows, and on a view one element past a
   16-byte boundary).  Then ``[check/grad]``: each wrapper under grad mode
   (flash attention at hd 64 and 96), whose output must carry a
   ``grad_fn`` and whose input gradients (the plain version's vjp) must
   match the plain version's own autograd;
3. time: each kernel, its plain version, and one PyTorch call computing the
   same function (``library_ms``; the port never calls it; none exists for
   WKV6 or the SSD scan), with CUDA events at the largest serving shape:
   ``call`` around 20 eager calls (host work included), ``device`` around
   the replay of a CUDA graph that captured the same 20 calls (the device
   alone; kernel and library call),
   and the two scans at the decode shape too; flash attention at hd 64
   (granite), hd 80 (zamba2), hd 96 (phi-3-vision, causal, H = Hkv 32)
   and hubert's encoder (B 4, S = T 1024, non-causal, H = Hkv 16, hd 80);
   the bound is computed from the shapes
   (bytes over 3.35 TB/s, operations over the H100's peak rate; each line
   prints both and names the one its ratio uses; the SSD's operations are
   those of the form its kernel computes, the f32 ones of the sequential
   form printed beside the chunked form's tensor-core ones).  The
   tensors of phases 2 and 3 are freed before phase 4;
4. forward: a 2-layer, full-width granite-3-2b forward, a 2-layer,
   full-width rwkv6-7b forward and a 2-layer, full-width zamba2-2.7b
   forward with the shared block after layer 1 (all f32), each with the
   same weights on the card (kernels) and on the CPU (plain versions): the
   max logit error, the argmax agreement and the launch counts;
   ``[forward/llama4]``, one full-width llama4-scout-17b-a16e layer (f32,
   weights drawn on the card and copied to the host, the last position's
   logits); ``[forward/phi3v]``, 2 full-width phi-3-vision-4.2b layers on
   (1, 640) inputs from ``input_specs``: a seeded (1, 576, 3072)
   ``image_embeds`` over the first positions and 64 text tokens; and
   ``[forward/hubert]``, 2 full-width hubert-xlarge layers on (2, 256,
   1280) frame embeddings, non-causal, with its GELU FFN;
5. train: ``[train/check]``, one ``make_train_step`` of a 2-layer,
   full-width granite-3-2b in f32 (remat on, B 2, S 128 from
   ``SyntheticLMPipeline``) on the card and on the CPU from the same
   weights: the loss (``TRAIN_LOSS_TOL``), every gradient, m and v leaf
   (``TRAIN_LEAF_RTOL``, scaled to the leaf), the update of every
   parameter and master leaf (``TRAIN_UPDATE_*``), and the step's launches;
   ``[train/granite]`` (``train_full_phase``), full-width, full-depth
   granite-3-2b (bf16
   parameters, f32 master, m and v, remat on) trained 6 steps at B 4, S
   1024 through ``make_train_step``: each step's loss, wall time and
   tokens/s, the model FLOPs share of the spec-sheet peak, the peak memory,
   each step's launches (asserted: 161 rmsnorm, 80 SwiGLU, 80 flash
   attention), finite losses and bf16 leaves after the last step;
   ``[plan]``, the port's copy of the planner: Table I at N 1024, w 64, the
   Fig. 4 optimal depths, and ``replan`` of the full granite step's bf16
   gradient bytes over 64 and 256 devices, each plan's factors multiplying
   to its world; ``[train/resume]``, reduced granite-3-2b in bf16 through
   ``Trainer`` and a ``Checkpointer``: 4 steps, a save, a fresh trainer
   restored from it, 2 more steps, equal bit for bit to 6 unbroken steps;
   ``[train/dp]`` (``train_dp_phase``), the training launcher ``python -m
   repro_torch.launch.train`` on full-width granite-3-2b (B 4, S 1024, 3
   steps), each run a subprocess with a timeout: on one device, as a
   data-parallel world of one NCCL rank (``--mesh 1,1 --zero1 explicit``,
   every gradient leaf through the context-planned reduce-scatter), and
   the same with ``--verify-collectives --fault-step 1``; each run's step
   times, peak memory, ``[train/comms]`` lines and launches (asserted per
   step), and the three runs' losses equal step for step (bit for bit
   expected; else within ``TRAIN_LOSS_TOL``, with the reason printed);
6. comms: the collective executors of ``repro_torch.comms``.
   ``[comms/card]``, an NCCL world of one rank on the card (one H100 holds
   one NCCL rank; the phase says so in a line of its own): ag, rs, ar and
   a2a through ``CommContext`` in the oneshot, chunked, perhop and hybrid
   modes on CUDA tensors of the paper's Fig. 4 message (4 MiB), each output
   on the card and equal bit for bit to the flat NCCL collective, timed
   with CUDA events; the latency exchange has no plan for one rank, which
   the phase prints.  ``[comms/gloo8]``, the test suite's world script
   (``tests/subproc/torch_comms_world.py --suite sizes``, torch only) on the
   card machine's host: 8 gloo ranks, meshes [2, 4] and [2, 2, 2], shards of
   64 KiB, 1 MiB and 4 MiB, every op in every mode (the latency exchange
   too) bit-identical to the flat one-shot collective, with its time.
   ``[comms/perf]``, ``python -m repro_torch.launch.perf --collectives 2,4
   --sizes-kb 64,4096 --device cpu``, its rows printed.  Then the fault
   layer: ``[fault/card]``, one NCCL rank, ``api.all_gather`` and
   ``api.all_reduce`` of a 4 MiB f32 CUDA tensor with ``PlanPolicy(verify=
   True)`` and without, bit-identical, no fallback, both timed, and
   ``execute_plan_verified`` on a per-hop plan (a world of one rank has no
   hop to fault, which the phase prints); ``[fault/gloo8]``, ``python
   tests/subproc/torch_fault_world.py --suite full``: 8 gloo ranks, mesh
   [2, 4], every check of the chaos harness (injected drops and
   corruptions detected, retried or fallen back to the one-shot, a fault
   on one ring position, the verify policy's fallback count,
   ``report_fault``, the dead axis, a seeded 16-step fault trace), then the
   verified-to-plain time ratio at a 1 MiB shard.  Each subprocess
   runs in a process group of its own, killed whole on a timeout;
7. tp: the explicit tensor-parallel transformer block
   (``models.model.transformer_block_tp`` on the executors of phase 6).
   ``[tp/card]``, an NCCL world of one rank on the card: one full-width
   granite-3-2b layer (bf16, random weights from a seed), B 4, S 1024, TP
   and SP, each output on the card, within ``TP_CARD_TOL`` of
   ``transformer_block_ref`` on the card (and whether it is bit-identical),
   within ``TP_CPU_RTOL`` of max |ref| of the CPU's f32 block on the same
   weights (batch row 0), each block launching rmsnorm twice, SwiGLU and
   flash attention once, and TP, SP and the one-device block timed with
   CUDA events.  ``[tp/gloo8]``, ``python tests/subproc/torch_tp_world.py
   --suite full`` on the card machine's host: 8 gloo ranks, the
   full-width layer in f32 at B 1, S 256, meshes [8] and [2, 4], TP and SP,
   the fused rings forced on, off and "auto", each rank within 1e-4 of max
   |ref| of the full layer's block, with ms per block; then ``python -m
   repro_torch.launch.perf --tp-block 2,4 --device cpu``, its rows printed.
   Then the expert-parallel MoE block (``models/moe.py`` on the same
   executors): ``[moe/card]``, one full-width llama4-scout MoE block (bf16,
   B 4, S 512) in an NCCL world of one rank, bit-identical to the
   one-device block, timed, with its all-to-all plans and cache counters;
   ``[moe/gloo8]``, ``python tests/subproc/torch_moe_world.py --suite
   full``: 8 gloo ranks, the same block in f32 with 2 experts a rank, B 1,
   S 64 a rank, within 1e-5 of max |ref| of the one-device block;
8. serve: full granite-3-2b (40 layers, bf16), full rwkv6-7b (32 layers,
   d 4096, bf16), full zamba2-2.7b (54 Mamba2 layers, d 2560, the shared
   block every 6th layer, bf16) and llama4-scout-17b-a16e at full width
   and 12 of its 48 layers (d 5120, 16 experts of 8192, top-1 and a shared
   expert; the depth cut so that its weights fit the card), random weights
   from a seed, each through
   ``BatchedServer`` (batch 4, max_seq 1024, 16 new tokens), 8 requests
   with prompt lengths from ``numpy.random.default_rng(0)`` in [64, 512];
   every request must finish with 16 tokens and each kernel's launch count
   must grow by what the schedule predicts.  Each serve reports its own
   peak memory: the peak since just before its drain, the memory allocated
   before its ``init_params``, and the peak above that.  Each serve also
   prints its decode forward's time against the time to read every stored
   weight once (the embedding table only where the head is tied to it);
9. cluster: ``[cluster/card]``, ``launch.serve``'s multi-replica path on
   the card: two full-width granite-3-2b replicas (bf16; r0 40 layers,
   r1-deep 80), each calibrated by ``measure_replica_times``, a seeded
   Poisson trace of 8 requests (8-token prompts, 16 new tokens, batch 4)
   at a quarter of r1-deep's service rate, replayed under round-robin and
   greedy routing through the event-driven simulator and the live
   ``ClusterServer``: every request finished with 16 tokens and every
   timestamp, ``routed`` summing to 8, the simulator's event log repeated
   from the same seed, B1-B3 launched (flash attention once a layer per
   prefill); it prints simulated and measured p50 and p99, whether their
   greedy < round-robin orderings match (not gated), its time and peak
   memory;
10. vlm and audio: ``[prefill/phi3v]``, full phi-3-vision-4.2b (32
   layers, bf16) prefilling B 4, S 1024 (576 image positions and 448
   tokens) into a decode state, ``head_mode="last"``: finite logits, one
   launch of each kernel a layer, and logits that differ from the same
   tokens' text-only prefill, with its time and peak memory;
   ``[serve/phi3v]``, the same model through ``serve_phase`` as the other
   serves (text prompts alone, as the reference's server serves it);
   ``[encode/hubert]``, full hubert-xlarge (48 layers, bf16) over B 4 x
   1024 frames, non-causal: finite logits, rmsnorm twice and flash
   attention once a layer, its time against its compute bound; and
   ``[train/hubert]``, hubert-xlarge trained 3 steps (bf16 parameters, f32
   master, m and v, remat on, B 4, S 1024, seeded frame embeddings and
   labels): finite losses, 193 rmsnorm and 96 flash launches a step, bf16
   leaves after the last, step time and peak memory.

The last lines are the ``{"kernels": [...]}`` line (``launches`` summed
over the 6 training steps of ``[train/granite]``, the 9 steps of
``[train/dp]``'s three launcher runs (each counted by the launcher from 0
just before its steps and reported in its ``[train/summary]`` line), the
four serves of phase 8, the two cluster replays of phase 9 and, of phase
10, the gated prefill, the serve, the gated encoder forward and the 3
training steps,
each counted from 0 just before it; ``max_abs_err`` the largest of phase
2's checks; the times from phase 3: ``ms`` and ``library_ms`` per call, ``device_ms`` and
``library_device_ms`` from the graph replay), the card's name and power limit as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives them, and ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: kernel vs plain version on the card, (rtol, atol) by dtype; the plain
#: versions round intermediates to bf16 where the kernels keep f32
TOL = {
    "rmsnorm": {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)},
    "swiglu": {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)},
    "flash_attention": {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)},
    # y; f32 as tests/test_kernels.py holds the Pallas kernel to its oracle
    "wkv6": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    # y and the state, f32 in both cases, as tests/test_kernels.py holds the
    # Pallas kernel to its oracle.  From bf16 x, B and C both sides widen
    # the same values to f32 exactly and run the same f32 recurrence, so
    # they differ only in the order of the f32 sums, as from f32 inputs.
    "mamba2_ssd": {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 1e-4)},
}
#: the WKV6 final state (f32 in both cases), (rtol, atol) by input dtype
WKV6_STATE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 1e-4)}
#: 2-layer f32 forward, card vs CPU: absolute logit error, argmax agreement
FORWARD_ATOL = 1e-3
FORWARD_ARGMAX_MIN = 0.99
TRAIN = dict(batch=4, seq=1024, steps=6, warmup_steps=2)
TRAIN_CHECK = dict(batch=2, seq=128)
#: [train/check], card vs CPU.  The loss, (rtol, atol): the reference's
#: fp32 tolerance.
TRAIN_LOSS_TOL = (1e-5, 1e-5)
#: The gradients and the moments, leaf by leaf: allclose at rtol r and
#: atol r * max|CPU leaf|, with r the reference's flash fp32 tolerance, as
#: the f32 flash kernel's forward differs from the plain version's by up
#: to that.  Scaled to each leaf, so a leaf of zeros fails (m is 0.1 and v
#: 0.05 times the clipped gradient and its square).
TRAIN_LEAF_RTOL = {"grad": 2e-4, "m": 2e-4, "v": 2e-4}
#: The parameters and the master, by their update u = p - p0.  A first
#: AdamW step moves an element by lr * (g / (|g| + eps) + wd * w), g the
#: clipped gradient: +-lr by its sign, but within a few eps of 0 the ratio
#: turns fast, so there the two devices' gradient difference moves the
#: update, up to 2 lr where the sign differs.  So every element's two
#: updates lie within 2 lr + 1e-6 of each other, and at most
#: TRAIN_UPDATE_OFF of all elements differ by more than lr / 100 (the f32
#: rounding of w + u at |w| <= 1 is lr / 2500).  Measured on the card: 432
#: of 222,832,640 elements (1.9e-6), all with |g| below a few eps, the
#: largest 0.165 lr; the limit is 5x that.  An update the card did not
#: apply, or applied scaled, differs by more at every element.  lr is
#: peak_lr / warmup_steps at step 1.
_LR1 = 3e-4 / TRAIN["warmup_steps"]
TRAIN_UPDATE_ATOL = 2 * _LR1 + 1e-6
TRAIN_UPDATE_CLOSE = _LR1 / 100
TRAIN_UPDATE_OFF = 1e-5

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
BF16_TENSOR_FLOP_S = 989e12
F32_FLOP_S = 67e12

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:31",
    "swiglu": "src/repro/kernels/swiglu.py:25",
    "flash_attention": "src/repro/kernels/flash_attention.py:79",
    "wkv6": "src/repro/kernels/rwkv6_scan.py:62",
    "mamba2_ssd": "src/repro/kernels/mamba2_scan.py:62",
}

DEVICE = "cuda:0"
#: llama4-scout-17b-a16e's served depth: 12 of its 48 layers fit one card
LLAMA4_LAYERS = 12
SERVE = dict(batch_size=4, max_seq=1024, max_new_tokens=16, requests=8,
             prompt_min=64, prompt_max=512)
CHECK_S = (128, 200, 512)  # prompt lengths of the per-kernel checks
WKV6_CHECK_S = (1, 37, 65) + CHECK_S  # decode, ragged staged chunks, prompt lengths
#: decode, ragged chunks, either side of two and of four of the SSD chunked
#: kernel's 32-step chunks, prompt lengths
SSD_CHECK_S = (1, 37, 63, 64, 65, 129) + CHECK_S
SSD_EDGE_S = (1, 65, 200)  # with decays of exactly 0 and 1
TIME_S = 512  # the longest prompt: the timed shapes
#: phi-3-vision's prefill: the 576-position image prefix and 448 text tokens
VLM_PREFILL = dict(batch=4, seq=1024)
#: hubert-xlarge's encoder: 1024 frames, about 20 s of 16 kHz audio at its
#: 20 ms frame rate; the training run's steps
AUDIO = dict(batch=4, seq=1024, train_steps=3)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call: CUDA events around one replay of a CUDA graph
    that captured ``reps`` calls of ``fn``, so no host work paces the
    launches.  ``fn`` has run eagerly before (lazy initialisation)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def predict_forwards(prompt_lens, batch_size, new_tokens, max_seq):
    """(prefills, decode forwards) of BatchedServer's schedule for these
    prompts: refill free slots, then one decode micro-batch per distinct
    slot position.  Independent of the model: no EOS, so only lengths
    decide when a request ends."""
    queue = list(prompt_lens)
    slots = [None] * batch_size  # [pos, generated] or None
    prefills = decodes = 0
    while queue or any(slots):
        for i in range(batch_size):
            if slots[i] is None and queue:
                slots[i] = [queue.pop(0), 1]
                prefills += 1
                if new_tokens <= 1:
                    slots[i] = None
        active = [i for i in range(batch_size) if slots[i] is not None]
        for pos in sorted({slots[i][0] for i in active}):
            decodes += 1
            for i in active:
                if slots[i] is not None and slots[i][0] == pos:
                    slots[i][0] += 1
                    slots[i][1] += 1
                    if slots[i][1] >= new_tokens or slots[i][0] >= max_seq - 1:
                        slots[i] = None
    return prefills, decodes


def leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [tree]


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spec_batch(cfg, batch, seq, kind="prefill", seed=1):
    """Torch CPU inputs of ``cfg`` at (batch, seq), one for each key of the
    port's ``input_specs`` (the reference's keys): token ids and labels
    drawn from ``numpy.random.default_rng(seed)`` in the vocabulary, frame
    and image embeddings N(0, 1) in f32 (the model casts them)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, input_specs

    rng = np.random.default_rng(seed)
    out = {}
    for key, spec in input_specs(cfg, ShapeConfig("smoke", seq, batch, kind)).items():
        if spec.dtype == torch.int32:
            out[key] = torch.from_numpy(rng.integers(0, cfg.vocab_size, spec.shape))
        else:
            out[key] = torch.from_numpy(rng.standard_normal(spec.shape, dtype=np.float32))
    return out


def forward_phase(name, cfg, dev, expect_launches, layers=2, head_mode="full",
                  draw_on_card=False, shape=(2, 128)):
    """A ``layers``-layer, full-width f32 forward of ``cfg`` with the same
    weights on the card (kernels) and on the CPU (plain versions), drawn on
    the CPU or, with ``draw_on_card`` (llama4's 17 GB), on the card, on the
    inputs ``spec_batch`` makes at ``shape`` (phi-3-vision's include its
    image prefix, hubert's are frame embeddings)."""
    import torch

    from repro_torch.kernels import KERNELS
    from repro_torch.models import forward, init_params

    cfg2 = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    if draw_on_card:
        p_gpu = init_params(cfg2, seed=0, device=dev)
        p_cpu = to_device(p_gpu, "cpu")
    else:
        p_cpu = init_params(cfg2, seed=0, device="cpu")
        p_gpu = to_device(p_cpu, dev)
    b_cpu = spec_batch(cfg2, *shape)
    inputs = {k: tuple(v.shape) for k, v in b_cpu.items()}
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        got, _ = forward(cfg2, p_gpu, to_device(b_cpu, dev), head_mode=head_mode)
        torch.cuda.synchronize()
        launches = {n: kern.launches for n, kern in KERNELS.items()}
        t1 = time.perf_counter()
        want, _ = forward(cfg2, p_cpu, b_cpu, head_mode=head_mode)
    t2 = time.perf_counter()
    got = got.cpu()
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    n_params = sum(t.numel() for t in leaves(p_cpu))
    print(f"[forward/{name}] {layers}-layer full-width f32 {inputs} head_mode={head_mode} "
          f"({n_params / 1e9:.3f} B parameters): max_abs_logit_err={err:.3e} "
          f"(atol {FORWARD_ATOL}) argmax_agreement={agree:.4f} "
          f"logit_absmax={float(want.abs().max()):.3f} launches={launches} "
          f"(predicted {expect_launches}); card {t1 - t0:.2f}s, cpu {t2 - t1:.2f}s")
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          f"{name} card forward: non-finite logits or wrong shape")
    check(err <= FORWARD_ATOL, f"{name} card forward disagrees with the CPU forward")
    check(agree >= FORWARD_ARGMAX_MIN, f"{name} card forward argmax disagrees with the CPU")
    check(launches == expect_launches,
          f"{name} card forward did not go through the kernels: {launches}")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


def train_check_phase(cfg, dev):
    """[train/check]: one training step of a 2-layer, full-width f32
    granite-3-2b on the card (kernels) and on the CPU (plain versions)."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import KERNELS
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import tree_leaves

    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p_cpu = init_params(cfg2, seed=0, device="cpu")
    p_gpu = to_device(p_cpu, dev)
    raw = next(SyntheticLMPipeline(DataConfig(cfg2.vocab_size, TRAIN_CHECK["seq"],
                                              TRAIN_CHECK["batch"])))
    b_cpu = {k: torch.from_numpy(v) for k, v in raw.items()}
    b_gpu = to_device(b_cpu, dev)

    def loss_and_grads(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(cfg2, params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    @torch.no_grad()
    def compare_loss(got, want):
        rtol, atol = TRAIN_LOSS_TOL
        err = abs(float(got) - float(want))
        ok = math.isfinite(float(got)) and bool(torch.allclose(got.cpu(), want, rtol=rtol,
                                                               atol=atol))
        print(f"[train/check] loss: card {float(got):.6f} cpu {float(want):.6f} "
              f"abs_err={err:.3e} (rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'}")
        check(ok, "[train/check] loss: the card's training step disagrees with the CPU's")

    @torch.no_grad()
    def compare_leaves(what, got, want):
        """Leaf by leaf, at rtol r and atol r * max|want|; prints the leaf
        whose error is the largest share of its max|want|."""
        rtol = TRAIN_LEAF_RTOL[what]
        ok, worst, scales = True, (-1.0, 0.0, 0.0, -1), []
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.detach().cpu().float(), w.float()
            scale, err = float(w.abs().max()), float((g - w).abs().max())
            scales.append(scale)
            ok = ok and bool(torch.isfinite(g).all()) and bool(
                torch.allclose(g, w, rtol=rtol, atol=rtol * scale))
            share = err / scale if scale else (0.0 if err == 0 else math.inf)
            worst = max(worst, (share, err, scale, i))
        share, err, scale, i = worst
        print(f"[train/check] {what}: {len(scales)} leaves, each within rtol {rtol} and atol "
              f"{rtol} x its max |value|; max |value| per leaf {min(scales):.3e} to "
              f"{max(scales):.3e}; worst leaf {i}: max_abs_err={err:.3e} of max |value| "
              f"{scale:.3e} = {share:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"[train/check] {what}: the card's training step disagrees with the CPU's")

    @torch.no_grad()
    def compare_update(what, got, want, before, m):
        """The card's update p - p0 against the CPU's (TRAIN_UPDATE_*); ``m``,
        the CPU's first moment, gives the clipped gradient (1 - b1) m."""
        n = off = 0
        err = g_off = 0.0
        finite = True
        for g, w, p0, m0 in zip(got, want, before, m):
            g = g.detach().cpu().float()
            finite = finite and bool(torch.isfinite(g).all())
            du = ((g - p0) - (w.float() - p0)).abs()
            err = max(err, float(du.max()))
            far = du > TRAIN_UPDATE_CLOSE
            off += int(far.sum())
            if far.any():
                g_off = max(g_off, float(m0[far].abs().max()) / (1 - opt_cfg.b1))
            n += du.numel()
        ok = finite and err <= TRAIN_UPDATE_ATOL and off <= TRAIN_UPDATE_OFF * n
        print(f"[train/check] {what}: {len(before)} leaves, update p - p0 card vs cpu: "
              f"max_abs_err={err:.3e} (atol {TRAIN_UPDATE_ATOL:.3e} = 2 lr + 1e-6), "
              f"{off} of {n} elements off by more than {TRAIN_UPDATE_CLOSE:.3e} = lr/100 "
              f"(at most {TRAIN_UPDATE_OFF * n:.0f}), their largest |clipped gradient| "
              f"{g_off:.3e} (eps {opt_cfg.eps}) {'ok' if ok else 'FAIL'}")
        check(ok, f"[train/check] {what}: the card's AdamW update disagrees with the CPU's")

    loss_g, grads_g = loss_and_grads(p_gpu, b_gpu)
    loss_c, grads_c = loss_and_grads(p_cpu, b_cpu)
    compare_loss(loss_g, loss_c)
    compare_leaves("grad", grads_g, grads_c)

    opt_cfg = OptimizerConfig(warmup_steps=TRAIN["warmup_steps"], decay_steps=TRAIN["steps"])
    o_gpu, o_cpu = adamw_init(p_gpu, opt_cfg), adamw_init(p_cpu, opt_cfg)
    for kern in KERNELS.values():
        kern.launches = 0
    p_gpu, o_gpu, m_gpu = make_train_step(cfg2, opt_cfg)(p_gpu, o_gpu, b_gpu)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in KERNELS.items()}
    # the master starts as the f32 parameters: one p0 for both
    before = [p.detach().float().clone() for p in tree_leaves(p_cpu)]
    p_cpu, o_cpu, m_cpu = make_train_step(cfg2, opt_cfg)(p_cpu, o_cpu, b_cpu)
    moment = tree_leaves(o_cpu["m"])
    compare_update("params", tree_leaves(p_gpu), tree_leaves(p_cpu), before, moment)
    compare_update("master", tree_leaves(o_gpu["master"]), tree_leaves(o_cpu["master"]), before,
                   moment)
    for key in ("m", "v"):
        compare_leaves(key, tree_leaves(o_gpu[key]), tree_leaves(o_cpu[key]))
    L = cfg2.num_layers
    expect = {n: 0 for n in KERNELS}
    expect.update(rmsnorm=4 * L + 1, swiglu=2 * L, flash_attention=2 * L)
    print(f"[train/check] 2-layer full-width f32 (B {TRAIN_CHECK['batch']}, S "
          f"{TRAIN_CHECK['seq']}), remat {cfg2.remat}: loss card {float(m_gpu['loss']):.6f} "
          f"cpu {float(m_cpu['loss']):.6f}; step launches {launches}")
    check(launches == expect, f"[train/check] launches {launches} != {expect}")


def train_full_phase(name, cfg, dev, batches):
    """[train/<name>]: ``cfg`` at full width and depth (bf16 parameters, f32
    master, m and v, remat on) trained on the card through
    ``make_train_step``, one step on each of ``batches`` (dicts of CPU
    tensors: tokens or frame embeddings, and labels).  Gates: finite
    losses, each step's launches (the forward runs twice a layer under
    remat: 4L + 1 rmsnorm, 2L flash attention, 2L SwiGLU where the FFN is
    SwiGLU; the backward is the plain versions' vjps), bf16 parameters and
    f32 AdamW state after the last step.  Returns (kernel launches over the
    steps, the bf16 gradient bytes of one step)."""
    import torch

    from repro_torch.configs import param_count
    from repro_torch.kernels import KERNELS
    from repro_torch.models import init_params
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import tree_leaves

    tag = f"[train/{name}]"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=dev)
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    grad_bytes = sum(p.numel() * p.element_size() for p in leaves)
    steps = len(batches)
    B, S = batches[0]["labels"].shape
    opt_cfg = OptimizerConfig(warmup_steps=TRAIN["warmup_steps"], decay_steps=steps)
    opt_state = adamw_init(params, opt_cfg)
    torch.cuda.synchronize()
    fixed = torch.cuda.memory_allocated() - before
    print(f"{tag} {cfg.name} {cfg.num_layers} layers d={cfg.d_model} {cfg.dtype} "
          f"remat={cfg.remat}: {n_params / 1e9:.3f} B parameters; parameters and AdamW state "
          f"(f32 master, m, v) {fixed / 2**30:.2f} GiB; B {B}, S {S}, {steps} steps")
    train_step = make_train_step(cfg, opt_cfg)
    L = cfg.num_layers
    expect = {n: 0 for n in KERNELS}
    expect.update(rmsnorm=4 * L + 1, flash_attention=2 * L,
                  swiglu=2 * L if cfg.family != "audio" else 0)
    # model FLOPs of one step: 6 per parameter and token in the matmuls
    # (the tied head counts once, the norms' scales not), and the attention
    # products' forward (4 hd per query-key pair; causal or all) three times
    mm_params = n_params - sum(p.numel() for p in leaves if p.dim() == 1)
    pairs = S * (S + 1) // 2 if cfg.causal else S * S
    attn_fwd = 4 * B * cfg.num_heads * cfg.head_dim * pairs * L
    model_flops = 6 * mm_params * B * S + 3 * attn_fwd
    # with remat the forward runs twice: 8 per parameter and token, 4x attention
    remat_flops = 8 * mm_params * B * S + 4 * attn_fwd
    total = {n: 0 for n in KERNELS}
    times, losses = [], []
    for step in range(steps):
        batch = to_device(batches[step], dev)
        for kern in KERNELS.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {n: k.launches for n, k in KERNELS.items()}
        for n in KERNELS:
            total[n] += launches[n]
        times.append(dt)
        losses.append(loss)
        print(f"{tag} step {step} loss {loss:.4f} time {dt:.3f}s "
              f"{B * S / dt:.1f} tokens/s launches {launches}")
        check(math.isfinite(loss), f"{tag} step {step}: loss {loss}")
        check(launches == expect, f"{tag} step {step}: launches {launches} != {expect}")
    peak = torch.cuda.max_memory_allocated()
    best = min(times[1:])
    print(f"{tag} steady step (best of steps 1-{steps - 1}) {best:.3f}s, "
          f"{B * S / best:.1f} tokens/s; model FLOPs {model_flops / 1e12:.2f} TFLOP a step "
          f"(with the remat forward {remat_flops / 1e12:.2f} TFLOP, "
          f"{remat_flops / BF16_TENSOR_FLOP_S:.4f} s at the spec-sheet peak); model FLOPs "
          f"share of the H100's {BF16_TENSOR_FLOP_S / 1e12:.0f} TFLOP/s bf16 spec-sheet peak "
          f"{model_flops / best / BF16_TENSOR_FLOP_S:.4f}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB before init_params); "
          f"param_count {param_count(cfg) / 1e9:.3f} B")
    dtypes = {str(p.dtype) for p in tree_leaves(params)}
    states = {str(t.dtype) for k in ("master", "m", "v") for t in tree_leaves(opt_state[k])}
    print(f"{tag} after step {steps - 1}: parameter dtypes {sorted(dtypes)}, "
          f"master/m/v dtypes {sorted(states)}; losses {[round(x, 4) for x in losses]}")
    check(dtypes == {"torch.bfloat16"}, f"{tag} a parameter left bf16: {dtypes}")
    check(states == {"torch.float32"}, f"{tag} AdamW state dtypes {states}")
    del params, opt_state, leaves, metrics, batch
    torch.cuda.empty_cache()
    return total, grad_bytes


def plan_phase(grad_bytes):
    """[plan]: the port's copy of the paper's planner, on a machine without jax."""
    from repro_torch.configs import optree_paper as paper
    from repro_torch.core import optimal_depth_argmin, table1
    from repro_torch.runtime import replan

    t0 = time.perf_counter()
    t1 = table1(paper.TABLE1_N, paper.TABLE1_W)
    print(f"[plan] Table I, N {paper.TABLE1_N}, w {paper.TABLE1_W}: "
          + ", ".join(f"{k} {v}" for k, v in t1.items()))
    depths = {n: optimal_depth_argmin(n, paper.SYSTEM.wavelengths) for n in paper.FIG4_NODES}
    print(f"[plan] Fig. 4 optimal depth at w {paper.SYSTEM.wavelengths}: "
          + ", ".join(f"N {n}: k {k}" for n, k in depths.items()))
    for world in (64, 256):
        plan = replan(world, grad_bytes)
        print(f"[plan] replan({world}, {grad_bytes} B: the granite-3-2b step's bf16 gradient) "
              f"factors {plan.factors}, modeled time {plan.total_time_s:.6f} s under the "
              f"planner's ICI_LINK model (the reference's link constants, not this card's), "
              f"chunks {plan.num_chunks}")
        check(math.prod(plan.factors) == world, f"[plan] factors {plan.factors} != {world}")
    print(f"[plan] done in {(time.perf_counter() - t0) * 1e3:.1f} ms")


def run_group(cmd, timeout_s, prefix):
    """Run ``cmd`` in a process group of its own, echo its standard output
    line by line, and on a timeout kill the whole group (the ranks it spawned
    too).  Returns the output lines; raises unless it exited 0."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{prefix} {' '.join(cmd)} ran past {timeout_s} s; killed")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # whatever it left behind
        except ProcessLookupError:
            pass
    lines = out.splitlines()
    for line in lines:
        print(line if line.startswith("[") else f"{prefix} {line}", flush=True)
    if proc.returncode != 0:
        print(err[-6000:], file=sys.stderr)
        raise RuntimeError(f"{prefix} {' '.join(cmd)} exited {proc.returncode}")
    return lines


def comms_card_phase(dev):
    """[comms/card]: the collective executors in an NCCL world of one rank
    on the card, on CUDA tensors of the paper's Fig. 4 message.  Every op
    in every mode through ``CommContext``, each output on the card and
    equal bit for bit to the flat one-shot collective."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.comms import FactorizedMesh, api, init_world
    from repro_torch.configs.optree_paper import FIG4_MESSAGE_BYTES

    print("[comms/card] one H100 holds one NCCL rank (NCCL refuses a duplicate GPU), "
          "so no multi-rank world runs on the card: this phase is a world of one "
          "rank (size-1 axes, rings of zero hops), and the 8-rank executors run "
          "under gloo on the host in [comms/gloo8]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rank_dev = init_world("cuda", world_size=1, rank=0,
                              store_path=os.path.join(tmp, "store"))
        try:
            check(dist.get_backend() == "nccl", f"[comms/card] backend {dist.get_backend()}")
            mesh = FactorizedMesh([1, 1], ("a", "b"))
            n = FIG4_MESSAGE_BYTES // 4
            g = torch.Generator(device=rank_dev).manual_seed(0)
            x = torch.randint(-64, 64, (n,), generator=g, device=rank_dev).float()
            names = ("a", "b")
            flat = {"ag": lambda: mesh.all_gather(x, names).reshape(-1),
                    "rs": lambda: mesh.psum_scatter(x, names),
                    "ar": lambda: mesh.psum(x, names),
                    "a2a": lambda: mesh.all_to_all(x, names)}
            ops = {"ag": api.all_gather, "rs": api.reduce_scatter,
                   "ar": api.all_reduce, "a2a": api.all_to_all}
            ctx = api.CommContext(mesh, names)
            for coll, op in ops.items():
                want = flat[coll]()
                flat_ms = time_ms(flat[coll])
                for mode, chunks in (("oneshot", None), ("chunked", 4),
                                     ("perhop", None), ("hybrid", 2)):
                    fn = (lambda op=op, mode=mode, chunks=chunks:
                          op(x, axis=0, ctx=ctx, mode=mode, num_chunks=chunks))
                    out = fn()
                    check(out.device.type == "cuda", f"[comms/card] {coll} {mode} on {out.device}")
                    check(out.shape == want.shape and torch.equal(
                        out.contiguous().view(torch.int32), want.contiguous().view(torch.int32)),
                        f"[comms/card] {coll} {mode} differs from the flat collective")
                    print(f"[comms/card] {coll} {FIG4_MESSAGE_BYTES} B {mode:<8} "
                          f"{time_ms(fn):.4f} ms (flat NCCL {flat_ms:.4f} ms), "
                          f"on {out.device}, bit-identical", flush=True)
            for coll in ("ag", "rs", "ar"):
                lat = api.CommContext(mesh, names, policy=api.PlanPolicy(regime="latency"))
                try:
                    ops[coll](x, axis=0, ctx=lat)
                except ValueError as err:
                    print(f"[comms/card] {coll} latency exchange: no plan in a world of "
                          f"one rank ({err}); the exchange executor runs in [comms/gloo8]")
                else:
                    raise RuntimeError(f"[comms/card] {coll}: a latency plan for one rank")
            st = ctx.cache_stats
            print(f"[comms/card] cache hits {st.hits} misses {st.misses}")
        finally:
            dist.destroy_process_group()


def comms_gloo8_phase():
    """[comms/gloo8]: the test suite's world script (torch only) on the
    card machine's host: 8 gloo ranks, meshes [2, 4] and [2, 2, 2], shards
    of 64 KiB, 1 MiB and 4 MiB, every op in every mode bit-identical to the
    flat one-shot collective, with its time."""
    t0 = time.perf_counter()
    lines = run_group([sys.executable, "tests/subproc/torch_comms_world.py",
                       "--suite", "sizes", "--sizes-kb", "64,1024,4096",
                       "--timeout", "500"], 560, "[comms/gloo8]")
    rows = [ln for ln in lines if ln.startswith("[comms/gloo8] mesh")]
    # 2 meshes x 3 sizes x (4 collectives x 4 modes + 3 latency chains)
    check(len(rows) == 2 * 3 * 19 and all(ln.endswith("bit-identical") for ln in rows),
          f"[comms/gloo8] {len(rows)} rows, want {2 * 3 * 19}")
    print(f"[comms/gloo8] host CPU under gloo: {len(rows)} runs bit-identical in "
          f"{time.perf_counter() - t0:.1f} s")


def comms_perf_phase():
    """[comms/perf]: ``launch.perf --collectives`` on 8 gloo ranks."""
    lines = run_group([sys.executable, "-m", "repro_torch.launch.perf", "--collectives",
                       "2,4", "--sizes-kb", "64,4096", "--device", "cpu",
                       "--timeout", "500"], 560, "[comms/perf]")
    rows = [ln for ln in lines if ln.startswith("[perf/collectives] ") and "KB mesh=" in ln]
    check(len(rows) == 6 and all(ln.endswith("bit-identical") for ln in rows),
          f"[comms/perf] {len(rows)} collective rows, want 6")


def fault_card_phase(dev):
    """[fault/card]: the verified executor (``PlanPolicy(verify=True)``) in
    an NCCL world of one rank on the card: ``api.all_gather`` and
    ``api.all_reduce`` of a 4 MiB f32 CUDA tensor (integers in [-4, 4], so
    every checksum is exact) with verification and without, bit-identical,
    no fallback, both timed with CUDA events; and ``execute_plan_verified``
    on a per-hop plan, every attempt clean.  A world of one rank has no
    ppermute hop, so an active injection finds nothing to hit (its
    ``applied`` stays 0); the phase says so in a line of its own."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.comms import (FactorizedMesh, FaultInjection, api,
                                   execute_plan_verified, fault_injection, init_world)
    from repro_torch.configs.optree_paper import FIG4_MESSAGE_BYTES

    print("[fault/card] a world of one rank (one H100 holds one NCCL rank) has size-1 "
          "axes and no ppermute hop, so no fault can be injected here: the injected "
          "drops and corruptions run on 8 gloo ranks in [fault/gloo8]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rank_dev = init_world("cuda", world_size=1, rank=0,
                              store_path=os.path.join(tmp, "store"))
        try:
            names = ("a", "b")
            mesh = FactorizedMesh([1, 1], names)
            g = torch.Generator(device=rank_dev).manual_seed(0)
            x = torch.randint(-4, 5, (FIG4_MESSAGE_BYTES // 4,), generator=g,
                              device=rank_dev).float()
            plain = api.CommContext(mesh, names)
            ver = api.CommContext(mesh, names, policy=api.PlanPolicy(verify=True))
            for coll, op in (("ag", api.all_gather), ("ar", api.all_reduce)):
                want = op(x, axis=0, ctx=plain)
                with fault_injection(FaultInjection(axis="b", mode="corrupt",
                                                    times=999)) as spec:
                    got = op(x, axis=0, ctx=ver)
                check(got.device.type == "cuda", f"[fault/card] {coll} on {got.device}")
                check(got.shape == want.shape and torch.equal(
                    got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)),
                    f"[fault/card] {coll}: verified differs from plain")
                check(spec.applied == 0, f"[fault/card] {coll}: a hop in a world of one")
                t_plain = time_ms(lambda: op(x, axis=0, ctx=plain))
                t_ver = time_ms(lambda: op(x, axis=0, ctx=ver))
                plan = ver.plans()[-1]
                print(f"[fault/card] {coll} {FIG4_MESSAGE_BYTES} B plan {plan.mode} "
                      f"x{plan.num_chunks}: plain {t_plain:.4f} ms, verified {t_ver:.4f} ms "
                      f"({t_ver / t_plain:.2f}x), on {got.device}, bit-identical", flush=True)
            check(ver.cache_stats.fallbacks == 0,
                  f"[fault/card] {ver.cache_stats.fallbacks} fallbacks in a healthy world")
            plan = plain.plan("ag", float(x.numel() * 4), shape=tuple(x.shape)).with_mode("perhop")
            out, diag = execute_plan_verified(x, plan, mesh=mesh, retries=1)
            check(torch.equal(out, x) and bool(diag["attempt_ok"].all())
                  and not bool(diag["used_fallback"]),
                  f"[fault/card] execute_plan_verified: {diag}")
            print(f"[fault/card] execute_plan_verified perhop ag: attempt_ok "
                  f"{diag['attempt_ok'].tolist()}, stage_ok {diag['stage_ok'].tolist()}, "
                  f"fallbacks 0")
        finally:
            dist.destroy_process_group()


def fault_gloo8_phase():
    """[fault/gloo8]: the test suite's fault world script (torch only) on
    the card machine's host: 8 gloo ranks, mesh [2, 4], every check of the
    chaos harness (drops and corruptions detected, retried or fallen back,
    a fault on one ring position, the verify policy's counting,
    ``report_fault``, the dead axis, the seeded trace loop), then verified
    against plain ``all_gather`` and ``all_reduce`` at a 1 MiB shard."""
    t0 = time.perf_counter()
    lines = run_group([sys.executable, "tests/subproc/torch_fault_world.py", "--suite",
                       "full", "--time-kb", "1024", "--reps", "3", "--timeout", "200"],
                      260, "[fault/gloo8]")
    (done,) = [ln for ln in lines if " checks passed " in ln]
    passed, total = done.split()[1].split("/")
    check(passed == total, f"[fault/gloo8] {done}")
    rows = [ln for ln in lines if ln.startswith("[fault/gloo8] mesh")]
    check(len(rows) == 2 and all(ln.endswith("bit-identical") for ln in rows),
          f"[fault/gloo8] {len(rows)} timing rows, want 2")
    print(f"[fault/gloo8] host CPU under gloo: {passed}/{total} checks, done in "
          f"{time.perf_counter() - t0:.1f} s")


#: [tp/card]: the explicit TP block against the one-device block, both
#: bf16 on the card: tests/test_kernels.py:23's bf16 tolerance; against the
#: CPU's f32 block, the largest error relative to max |CPU block|
TP_CARD_TOL = (2e-2, 2e-2)
TP_CPU_RTOL = 2e-2
TP_CARD = dict(batch=4, seq=1024)


def tp_card_phase(cfg, dev):
    """[tp/card]: ``transformer_block_tp``, TP and SP, in an NCCL world of
    one rank on the card, on one full-width granite-3-2b layer (bf16, B 4,
    S 1024): every output on the card, held to ``transformer_block_ref`` on
    the card and to the CPU's f32 block on the same weights, B1-B3 launched
    per block as the block predicts, and TP, SP and the one-device block
    timed with CUDA events."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.comms import FactorizedMesh, api, init_world
    from repro_torch.kernels import KERNELS
    from repro_torch.models import (
        shard_tp_layer,
        tp_block_specs,
        transformer_block_ref,
        transformer_block_tp,
    )
    from repro_torch.models.model import _layer_init
    from repro_torch.tree import tree_map

    print("[tp/card] one H100 holds one NCCL rank, so the TP block runs in a world of "
          "one rank here (size-1 axes); the 8-rank block runs under gloo in [tp/gloo8]",
          flush=True)
    B, S = TP_CARD["batch"], TP_CARD["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = _layer_init(gen, cfg, dtype=torch.bfloat16, device=dev)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(S, device=dev).expand(B, S)
    with torch.no_grad():
        ref = transformer_block_ref(layer, cfg, x, positions=pos)
        # the CPU's f32 block on the same (bf16) weights, batch row 0 (rows
        # are independent)
        cpu = transformer_block_ref(tree_map(lambda t: t.float().cpu(), layer), cfg,
                                    x[:1].float().cpu(), positions=pos[:1].cpu())
        ref_ms = time_ms(lambda: transformer_block_ref(layer, cfg, x, positions=pos),
                         reps=10)
    cpu_max = float(cpu.abs().max())
    names = ("tp",)
    none = {n: 0 for n in KERNELS}
    want_launches = dict(none, rmsnorm=2, swiglu=1, flash_attention=1)
    with tempfile.TemporaryDirectory() as tmp:
        init_world("cuda", world_size=1, rank=0, store_path=os.path.join(tmp, "store"))
        try:
            check(dist.get_backend() == "nccl", f"[tp/card] backend {dist.get_backend()}")
            mesh = FactorizedMesh([1], names)
            for sp in (False, True):
                tag = "sp" if sp else "tp"
                x_split, specs = tp_block_specs(layer, sequence_parallel=sp)
                local = shard_tp_layer(layer, specs, mesh, names)
                with api.comm_context(mesh, names) as ctx, torch.no_grad():
                    def block():
                        return transformer_block_tp(local, cfg, x, positions=pos,
                                                    sequence_parallel=sp)
                    torch.cuda.synchronize()
                    for kern in KERNELS.values():
                        kern.launches = 0
                    out = block()
                    torch.cuda.synchronize()
                    launches = {n: kern.launches for n, kern in KERNELS.items()}
                    ms = time_ms(block, reps=10)
                check(out.device.type == "cuda", f"[tp/card] {tag} output on {out.device}")
                check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                      f"[tp/card] {tag}: shape {tuple(out.shape)} or non-finite values")
                err = float((out.float() - ref.float()).abs().max())
                bitwise = torch.equal(out, ref)
                cpu_err = float((out[:1].float().cpu() - cpu).abs().max()) / cpu_max
                plans = sorted({f"{p.collective}:{p.mode}" for p in ctx.plans()})
                print(f"[tp/card] {tag} full granite-3-2b layer bf16 B {B} S {S} on "
                      f"{out.device}: {ms:.4f} ms per block (one-device block "
                      f"{ref_ms:.4f} ms); max_abs_err vs the card's one-device block "
                      f"{err:.3e} (rtol, atol {TP_CARD_TOL}), bit-identical {bitwise}; "
                      f"vs the CPU's f32 block (batch row 0) {cpu_err:.3e} of max |ref| "
                      f"(limit {TP_CPU_RTOL}); launches {launches}; plans {plans}",
                      flush=True)
                check(torch.allclose(out.float(), ref.float(), rtol=TP_CARD_TOL[0],
                                     atol=TP_CARD_TOL[1]),
                      f"[tp/card] {tag} differs from the one-device block")
                check(cpu_err <= TP_CPU_RTOL, f"[tp/card] {tag} differs from the CPU block")
                check(launches == want_launches,
                      f"[tp/card] {tag} launches {launches} != {want_launches}")
        finally:
            dist.destroy_process_group()
    del layer, x, ref
    torch.cuda.empty_cache()


def tp_gloo8_phase():
    """[tp/gloo8]: the test suite's TP world script (torch only) at full
    granite-3-2b width on the card machine's host: 8 gloo ranks, meshes
    [8] and [2, 4], TP and SP, fusion on, off and "auto", f32, B 1, S 256,
    each rank held to the full layer's block; then ``launch.perf
    --tp-block 2,4 --device cpu``."""
    t0 = time.perf_counter()
    lines = run_group([sys.executable, "tests/subproc/torch_tp_world.py", "--suite", "full",
                       "--reps", "2", "--timeout", "400"], 460, "[tp/gloo8]")
    rows = [ln for ln in lines if ln.startswith("[tp/gloo8] block-")]
    check(len(rows) == 2 * 2 * 3 and all(ln.endswith(" ok") for ln in rows),
          f"[tp/gloo8] {len(rows)} rows, want {2 * 2 * 3}")
    lines = run_group([sys.executable, "-m", "repro_torch.launch.perf", "--tp-block", "2,4",
                       "--device", "cpu", "--timeout", "200"], 260, "[tp/gloo8]")
    rows = [ln for ln in lines if ln.startswith("[perf/tp-block] ") and " fuse=" in ln]
    check(len(rows) == 6 and all(ln.endswith("allclose=True") for ln in rows),
          f"[tp/gloo8] launch.perf --tp-block printed {len(rows)} rows, want 6")
    print(f"[tp/gloo8] host CPU under gloo: done in {time.perf_counter() - t0:.1f} s")


#: [moe/card]: one full-width llama4-scout MoE block, bf16
MOE_CARD = dict(batch=4, seq=512)


def moe_card_phase(lcfg, dev):
    """[moe/card]: the expert-parallel MoE block (``expert_parallel(cfg,
    "ep")``) in an NCCL world of one rank on the card, on one full-width
    llama4-scout MoE block (bf16, random weights from a seed, B 4, S 512):
    bit-identical to the one-device block, output and aux, SwiGLU launched
    twice a block (the routed experts and the shared one), both timed with
    CUDA events in three alternating rounds, with the all-to-all plans
    issued and the cache counters."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.comms import FactorizedMesh, api, init_world
    from repro_torch.configs import expert_parallel
    from repro_torch.kernels import KERNELS
    from repro_torch.models.moe import moe_block, moe_init

    print("[moe/card] one H100 holds one NCCL rank, so the expert-parallel block runs in "
          "a world of one rank here (the expert axis has size 1, all 16 experts local, "
          "each all-to-all a copy); the 8-rank block runs under gloo in [moe/gloo8]",
          flush=True)
    B, S = MOE_CARD["batch"], MOE_CARD["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe_init(gen, lcfg, dtype=torch.bfloat16, device=dev)
    x = torch.randn((B, S, lcfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        ref, ref_aux = moe_block(p, lcfg, x)
    ep = expert_parallel(lcfg, "ep")
    with tempfile.TemporaryDirectory() as tmp:
        init_world("cuda", world_size=1, rank=0, store_path=os.path.join(tmp, "store"))
        try:
            check(dist.get_backend() == "nccl", f"[moe/card] backend {dist.get_backend()}")
            mesh = FactorizedMesh([1], ("ep",))
            with api.comm_context(mesh, ("ep",)) as ctx, torch.no_grad():
                torch.cuda.synchronize()
                for kern in KERNELS.values():
                    kern.launches = 0
                out, aux = moe_block(p, ep, x)
                torch.cuda.synchronize()
                launches = {n: kern.launches for n, kern in KERNELS.items()}
                usage = [(f"{q.collective}:{q.mode}", c) for q, c in ctx.plan_usage()]
                # alternated, so that a drift of the card's clocks shows in both
                rounds = [(time_ms(lambda: moe_block(p, ep, x), reps=10),
                           time_ms(lambda: moe_block(p, lcfg, x), reps=10))
                          for _ in range(3)]
            st = ctx.cache_stats
        finally:
            dist.destroy_process_group()
    bitwise = torch.equal(out, ref) and all(torch.equal(aux[k], ref_aux[k]) for k in aux)
    want = {n: 0 for n in KERNELS}
    want.update(swiglu=2)
    print(f"[moe/card] {lcfg.name} MoE block d {lcfg.d_model} E {lcfg.moe.num_experts} "
          f"top-{lcfg.moe.top_k} d_ff {lcfg.moe.d_ff_expert} bf16 B {B} S {S} on "
          f"{out.device}: ms per block in three alternating rounds, expert-parallel "
          f"{', '.join(f'{a:.4f}' for a, _ in rounds)}, one-device "
          f"{', '.join(f'{b:.4f}' for _, b in rounds)}; bit-identical (output and aux) {bitwise}; load_balance "
          f"{float(aux['load_balance']):.6f} router_z {float(aux['router_z']):.6f}; launches "
          f"{launches}; plans issued in one block {usage}; cache hits {st.hits} misses "
          f"{st.misses}", flush=True)
    check(out.device.type == "cuda" and bool(torch.isfinite(out).all()),
          "[moe/card] output off the card or non-finite")
    check(bitwise, "[moe/card] the expert-parallel block differs from the one-device block")
    check(any(u.startswith("a2a:") for u, _ in usage), "[moe/card] no all-to-all planned")
    check(launches == want, f"[moe/card] launches {launches} != {want}")
    del p, x, ref, out
    torch.cuda.empty_cache()


def moe_gloo8_phase():
    """[moe/gloo8]: the test suite's MoE world script (torch only) at full
    llama4-scout width on the card machine's host: 8 gloo ranks, the
    experts over the mesh [8] (2 a rank), f32, B 1, S 64 a rank, each rank
    within 1e-5 of max |ref| of the one-device block."""
    t0 = time.perf_counter()
    lines = run_group([sys.executable, "tests/subproc/torch_moe_world.py", "--suite", "full",
                       "--reps", "2", "--timeout", "240"], 300, "[moe/gloo8]")
    rows = [ln for ln in lines if ln.startswith("[moe/gloo8] ")]
    check(len(rows) == 1 and rows[0].endswith(" ok"), f"[moe/gloo8] rows {rows}")
    print(f"[moe/gloo8] host CPU under gloo: done in {time.perf_counter() - t0:.1f} s")


def train_resume_phase(cfg, dev):
    """[train/resume]: reduced granite-3-2b in bf16 through ``Trainer``: 4
    steps and a save, a fresh trainer restored, 2 more steps, against 6
    unbroken steps, bit for bit."""
    import tempfile

    import torch

    from repro_torch.configs import reduced
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import init_params
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    rcfg = dataclasses.replace(reduced(cfg), dtype="bfloat16")
    ocfg = OptimizerConfig(warmup_steps=2, decay_steps=6)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        def trainer(steps, sub):
            params = init_params(rcfg, seed=0, device=dev)
            return Trainer(rcfg, ocfg, TrainerConfig(total_steps=steps, ckpt_interval=4,
                                                     ckpt_dir=str(Path(tmp) / sub)),
                           params=params, opt_state=adamw_init(params, ocfg),
                           pipeline=SyntheticLMPipeline(DataConfig(rcfg.vocab_size, 64, 4)))

        whole = trainer(6, "whole")
        want = whole.run()["losses"]
        first = trainer(4, "cut")
        got = first.run()["losses"]
        second = trainer(6, "cut")
        restored = second.try_restore()
        step = second.step
        got += second.run()["losses"]
        same_params = all(torch.equal(a, b) for a, b in
                          zip(tree_leaves(second.params), tree_leaves(whole.params)))
        same_opt = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(second.opt_state), tree_leaves(whole.opt_state)))
        dtypes = sorted({str(p.dtype) for p in tree_leaves(second.params)})
        devices = sorted({str(p.device) for p in tree_leaves(second.params)})
    print(f"[train/resume] reduced granite-3-2b bf16 on {devices}: restored step {step}; "
          f"losses {got} vs unbroken {want}; parameters equal {same_params}, optimizer "
          f"state equal {same_opt}; parameter dtypes {dtypes}")
    check(restored and step == 4, "[train/resume] the restore did not find step 4")
    check(got == want and same_params and same_opt,
          "[train/resume] the resumed run differs from the unbroken one")
    check(all(math.isfinite(x) for x in got), "[train/resume] non-finite loss")


#: [train/dp]: the launcher's runs, each a subprocess; full-width granite-3-2b
TRAIN_DP = dict(seq=1024, batch=4, steps=3, timeout_s=420)
TRAIN_DP_RUNS = {
    "one-device": [],
    "mesh": ["--mesh", "1,1", "--zero1", "explicit"],
    "verified": ["--mesh", "1,1", "--zero1", "explicit", "--verify-collectives",
                 "--fault-step", "1"],
}


def train_dp_phase(cfg, card):
    """[train/dp]: ``python -m repro_torch.launch.train`` on full-width,
    full-depth granite-3-2b (B 4, S 1024, 3 steps, no checkpoint) three
    ways: on one device, as a data-parallel world of one NCCL rank (``--mesh
    1,1 --zero1 explicit``: the OpTree-planned reduce-scatter of every
    gradient leaf; one rank gathers nothing back), and the same with
    ``--verify-collectives --fault-step 1``.  Each run is a subprocess with
    a timeout; its ``[train/comms]`` lines are echoed.  Gates: each run's
    losses finite and its launches 161 rmsnorm, 80 SwiGLU and 80 flash
    attention a step (B1-B3 on the card, no plain version); the three runs'
    losses equal step for step, bit for bit expected on one rank, else
    within ``TRAIN_LOSS_TOL`` with the reason printed.  Prints each run's
    step times and peak memory beside the card's name and power limit.
    Returns the kernel launches summed over the three runs."""
    from repro_torch.kernels import KERNELS

    L = cfg.num_layers
    per_step = {n: 0 for n in KERNELS}
    per_step.update(rmsnorm=4 * L + 1, swiglu=2 * L, flash_attention=2 * L)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", cfg.name,
            "--seq", str(TRAIN_DP["seq"]), "--batch", str(TRAIN_DP["batch"]),
            "--steps", str(TRAIN_DP["steps"]), "--log-every", "1", "--ckpt-interval", "0"]
    total = {n: 0 for n in KERNELS}
    summaries = {}
    for name, extra in TRAIN_DP_RUNS.items():
        tag = f"[train/dp {name}]"
        t0 = time.perf_counter()
        lines = run_group(base + extra, TRAIN_DP["timeout_s"], tag)
        (line,) = [ln for ln in lines if ln.startswith("[train/summary] ")]
        s = json.loads(line[len("[train/summary] "):])
        summaries[name] = s
        steps = TRAIN_DP["steps"]
        print(f"{tag} {' '.join(extra) or '(no --mesh)'}: {s['ranks']} rank(s); step times "
              f"{[round(t, 4) for t in s['step_s']]} s (steady {min(s['step_s'][1:]):.4f} s); "
              f"peak max_memory_allocated {s['peak_bytes'] / 2**30:.2f} GiB; losses "
              f"{s['losses']}; launches {s['launches']}; run {time.perf_counter() - t0:.1f} s "
              f"on {card}", flush=True)
        check(len(s["losses"]) == steps and all(math.isfinite(x) for x in s["losses"]),
              f"{tag} losses {s['losses']}")
        want = {n: steps * c for n, c in per_step.items()}
        check(s["launches"] == want, f"{tag} launches {s['launches']} != {want}")
        if "--verify-collectives" in extra:
            check(any(ln.startswith("[train/fault] step 1:") for ln in lines),
                  f"{tag} no [train/fault] line")
        if extra:
            check(any(ln.startswith("[train/comms-json] ") for ln in lines),
                  f"{tag} no [train/comms-json] line")
        for n in KERNELS:
            total[n] += s["launches"][n]
    want = summaries["one-device"]["losses"]
    for name in ("mesh", "verified"):
        got = summaries[name]["losses"]
        if got == want:
            print(f"[train/dp] {name}: losses equal the one-device run's bit for bit")
            continue
        rtol, atol = TRAIN_LOSS_TOL
        close = all(abs(g - w) <= atol + rtol * abs(w) for g, w in zip(got, want))
        print(f"[train/dp] {name}: losses differ from the one-device run's by up to "
              f"{max(abs(g - w) for g, w in zip(got, want)):.3e} though one rank's "
              f"reduce-scatter returns its input: a kernel or library call is not "
              f"deterministic; within TRAIN_LOSS_TOL {TRAIN_LOSS_TOL}: {close}")
        check(close, f"[train/dp] {name}: losses {got} != {want}")
    return total


def serve_phase(name, cfg, dev, per_forward):
    """Serve ``SERVE["requests"]`` requests on ``cfg`` (bf16, random weights
    from seed 0); ``per_forward(L, is_prefill)`` gives each kernel's
    launches per forward.  Also prints the decode forward's time against
    its weight-read bound: every stored weight read once at the spec-sheet
    HBM rate, the embedding table only where the head is tied to it.
    Returns the kernels' launches over the drain."""
    import numpy as np
    import torch

    from repro_torch.kernels import KERNELS
    from repro_torch.models import init_params
    from repro_torch.runtime import BatchedServer, ServerConfig

    torch.cuda.synchronize()
    before_init = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    read_bytes = n_bytes
    if not cfg.tie_embeddings:  # decode gathers B rows of the table, no more
        read_bytes -= params["embed"].numel() * params["embed"].element_size()
    print(f"[serve/{name}] {cfg.name} {cfg.num_layers} layers d={cfg.d_model} {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters ({n_bytes / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t0:.1f}s")
    scfg = ServerConfig(batch_size=SERVE["batch_size"], max_seq=SERVE["max_seq"],
                        max_new_tokens=SERVE["max_new_tokens"])
    server = BatchedServer(cfg, params, scfg, device=dev)
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(SERVE["prompt_min"], SERVE["prompt_max"] + 1,
                                         size=SERVE["requests"])]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    server.submit(prompts[0][:16])  # warm-up: cuBLAS handles, allocator
    server.run_until_drained()
    server.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    for p in prompts:
        server.submit(p)
    results_tok = server.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()

    rep = server.drain_report()
    prefills, decodes = predict_forwards(lens, scfg.batch_size, scfg.max_new_tokens,
                                         scfg.max_seq)
    L = cfg.num_layers
    expect = {n: prefills * per_forward(L, True)[n] + decodes * per_forward(L, False)[n]
              for n in KERNELS}
    print(f"[serve/{name}] prompts {lens}; {rep['requests']} requests, {rep['tokens']} tokens "
          f"in {wall:.3f}s: {rep['throughput_tok_s']:.2f} tok/s, ttft_p50 "
          f"{rep['ttft_p50_s'] * 1e3:.2f} ms, latency p50 {rep['latency_p50_s'] * 1e3:.2f} ms "
          f"p99 {rep['latency_p99_s'] * 1e3:.2f} ms, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({before_init / 2**30:.2f} GiB allocated before "
          f"init_params, peak above that {(peak - before_init) / 2**30:.2f} GiB)")
    print(f"[serve/{name}] schedule: {prefills} prefills, {decodes} decode forwards; "
          f"launches {launches}, predicted {expect}")
    # prefills block the engine one at a time, so the rest of the drain is decode
    prefill_s = sum(r["prefill_done_s"] - r["prefill_start_s"] for r in rep["per_request"])
    print(f"[serve/{name}] time split: prefill {prefill_s:.3f}s "
          f"({prefill_s / prefills * 1e3:.2f} ms per prefill at batch {scfg.batch_size}), "
          f"decode and host bookkeeping {wall - prefill_s:.3f}s "
          f"({(wall - prefill_s) / decodes * 1e3:.2f} ms per decode forward)")
    bound_ms = read_bytes / HBM_BYTES_S * 1e3
    per_decode = (wall - prefill_s) / decodes * 1e3
    what = "weights, each expert's included" if cfg.moe is not None else "weights"
    print(f"[serve/{name}] decode forward {per_decode:.2f} ms against its weight-read "
          f"bound {bound_ms:.2f} ms ({read_bytes / 1e9:.2f} GB of {what}, read once at "
          f"{HBM_BYTES_S / 1e12:.2f} TB/s): {per_decode / bound_ms:.2f}x")
    check(rep["requests"] == SERVE["requests"] and len(results_tok) == SERVE["requests"],
          f"{name}: served {rep['requests']} of {SERVE['requests']} requests")
    for rid, toks_out in results_tok.items():
        check(len(toks_out) == SERVE["max_new_tokens"],
              f"{name}: request {rid} finished with {len(toks_out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks_out),
              f"{name}: request {rid} emitted a token outside the vocabulary")
    check(launches == expect, f"{name}: kernel launches {launches} != predicted {expect}")
    del server, params
    torch.cuda.empty_cache()
    return launches


#: [cluster/card]: two full-width granite-3-2b replicas, r1-deep twice as
#: deep; batch 4, 8 requests of 8-token prompts, 16 new tokens each
CLUSTER = dict(hetero_factor=2, batch_size=4, max_seq=128, new_tokens=16, requests=8)
#: the Poisson rate is this share of r1-deep's measured single-request
#: service rate: the underloaded regime of tests/test_cluster.py
CLUSTER_LOAD = 0.25


def cluster_card_phase(cfg, dev):
    """[cluster/card]: ``launch.serve``'s cluster path (``build_cluster``,
    ``cluster_trace``, ``run_cluster``) on the card: replicas r0 (40
    layers) and r1-deep (80 layers), bf16, random weights from seeds 0 and
    1, calibrated by ``measure_replica_times``; a Poisson trace at
    ``CLUSTER_LOAD`` of r1-deep's service rate, replayed under round-robin
    and greedy in the electrical world, through the simulator and the live
    ``ClusterServer``.  Gates: every request finishes with 16 tokens and
    full timestamps, ``routed`` sums to 8, the simulator's event log repeats
    from the same seed, and B1-B3 launch in the replay (flash attention
    exactly once a layer per prefill).  The greedy < round-robin p99
    ordering, measured against simulated, is printed, not gated.  Returns
    the kernels' launches over both replays."""
    import torch

    from repro_torch.cluster import ClusterSim, Request, make_policy
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    args = serve.build_parser().parse_args([
        "--arch", "granite-3-2b", "--device", str(dev), "--replicas", "2", "--hetero",
        "--hetero-factor", str(CLUSTER["hetero_factor"]),
        "--batch-size", str(CLUSTER["batch_size"]), "--max-seq", str(CLUSTER["max_seq"]),
        "--new-tokens", str(CLUSTER["new_tokens"]), "--requests", str(CLUSTER["requests"]),
        "--world", "electrical"])
    servers, specs = serve.build_cluster(args, cfg)
    layers = {spec.name: srv.cfg.num_layers for srv, spec in zip(servers, specs)}
    gb = {spec.name: sum(t.numel() * t.element_size() for t in leaves(srv.params)) / 1e9
          for srv, spec in zip(servers, specs)}
    print(f"[cluster/card] replicas {layers} layers, {cfg.dtype} weights "
          f"{ {k: round(v, 2) for k, v in gb.items()} } GB, built and calibrated in "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    probe = Request(rid=0, arrival_s=0.0, prompt_tokens=8, new_tokens=CLUSTER["new_tokens"])
    rate = CLUSTER_LOAD / specs[1].request_service_s(probe)
    args.trace = f"poisson:{rate!r}"
    trace = serve.cluster_trace(args)
    print(f"[cluster/card] trace {args.trace} ({CLUSTER_LOAD} / r1-deep's request service "
          f"{specs[1].request_service_s(probe) * 1e3:.2f} ms): arrivals "
          f"{[round(r.arrival_s, 3) for r in trace]} s", flush=True)
    p99, total = {}, {n: 0 for n in KERNELS}
    for policy in ("round-robin", "greedy"):
        args.policy = policy
        for kern in KERNELS.values():
            kern.launches = 0
        t0 = time.perf_counter()
        res = serve.run_cluster(args, servers, specs, trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: kern.launches for n, kern in KERNELS.items()}
        sim, meas = res["simulated"], res["measured"]
        check(len(meas.records) == len(trace) and len(res["results"]) == len(trace),
              f"[cluster/card] {policy}: {len(meas.records)} of {len(trace)} requests")
        for rec in meas.records:
            check(rec.new_tokens == CLUSTER["new_tokens"] and None not in (
                rec.enqueue_s, rec.prefill_start_s, rec.prefill_done_s,
                rec.decode_start_s, rec.finish_s),
                f"[cluster/card] {policy}: request {rec.rid} {rec.to_json()}")
        check(all(len(v) == CLUSTER["new_tokens"] for v in res["results"].values()),
              f"[cluster/card] {policy}: a stream is short")
        check(sum(meas.routed.values()) == len(trace) == sum(sim.routed.values()),
              f"[cluster/card] {policy}: routed {meas.routed}, simulated {sim.routed}")
        again = ClusterSim(specs, make_policy(policy), world=args.world)
        again.run(trace)
        check(again.event_log == res["event_log"],
              f"[cluster/card] {policy}: the simulator's event log differs on a rerun")
        # run_cluster counts from 0 after its warm requests: one prefill a
        # request of the replay, each launching flash once a layer
        prefill_layers = sum(layers[r.replica] for r in meas.records)
        check(launches["flash_attention"] == prefill_layers and launches["rmsnorm"] > 0
              and launches["swiglu"] > 0,
              f"[cluster/card] {policy}: launches {launches}, flash predicted {prefill_layers}")
        forwards = launches["rmsnorm"] - 2 * launches["swiglu"]  # 2L+1 vs L a forward
        for n in KERNELS:
            total[n] += launches[n]
        p99[policy] = (sim.latency_p99_s(), meas.latency_p99_s())
        print(f"[cluster/card] {policy}: simulated p50 {sim.latency_p50_s() * 1e3:.2f} ms "
              f"p99 {sim.latency_p99_s() * 1e3:.2f} ms routed {sim.routed}; measured p50 "
              f"{meas.latency_p50_s() * 1e3:.2f} ms p99 {meas.latency_p99_s() * 1e3:.2f} ms "
              f"routed {meas.routed}, makespan {meas.makespan_s:.3f} s, "
              f"{meas.throughput_tok_s():.2f} tok/s, replay {wall:.1f}s; launches {launches} "
              f"({forwards} forwards); event log of "
              f"{len(res['event_log'])} events repeats", flush=True)
    sim_order = p99["greedy"][0] < p99["round-robin"][0]
    meas_order = p99["greedy"][1] < p99["round-robin"][1]
    print(f"[cluster/card] greedy < round-robin on p99: simulated {sim_order}, measured "
          f"{meas_order}: {'match' if sim_order == meas_order else 'no match'} "
          f"(wall clock, not gated)")
    peak = torch.cuda.max_memory_allocated()
    print(f"[cluster/card] phase {time.perf_counter() - t_phase:.1f}s, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB allocated before it)")
    del servers, specs
    torch.cuda.empty_cache()
    return total


def prefill_vlm_phase(vcfg, dev):
    """[prefill/phi3v]: full phi-3-vision-4.2b (bf16, random weights from
    seed 0) prefills B 4, S 1024 into a decode state: the image prefix
    ``image_embeds`` over positions [0, 576) and 448 text tokens,
    ``head_mode="last"``.  Gates: finite logits, one launch of each kernel
    a layer (rmsnorm 2L + 1), and last-position logits that differ from the
    same tokens' text-only prefill (the prefix is used).  Prints the
    prefill's time and the peak memory.  Returns the launches of the gated
    prefill."""
    import torch

    from repro_torch.kernels import KERNELS
    from repro_torch.models import forward, init_decode_state, init_params

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    B, S = VLM_PREFILL["batch"], VLM_PREFILL["seq"]
    params = init_params(vcfg, seed=0, device=dev)
    batch = to_device(spec_batch(vcfg, B, S, seed=2), dev)
    state = init_decode_state(vcfg, B, S, device=dev)
    L = vcfg.num_layers
    with torch.no_grad():
        forward(vcfg, params, batch, cache=state, cache_pos=0, head_mode="last")  # warm-up
        torch.cuda.synchronize()
        for kern in KERNELS.values():
            kern.launches = 0
        t0 = time.perf_counter()
        logits, _ = forward(vcfg, params, batch, cache=state, cache_pos=0, head_mode="last")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {n: kern.launches for n, kern in KERNELS.items()}
        text, _ = forward(vcfg, params, {"tokens": batch["tokens"]}, cache=state,
                          cache_pos=0, head_mode="last")
    peak = torch.cuda.max_memory_allocated()
    want = {n: 0 for n in KERNELS}
    want.update(rmsnorm=2 * L + 1, swiglu=L, flash_attention=L)
    diff = float((logits - text).abs().max())
    scale = float(logits.abs().max())
    agree = float((logits.argmax(-1) == text.argmax(-1)).float().mean())
    n_tokens = S - vcfg.num_prefix_embeds
    print(f"[prefill/phi3v] {vcfg.name} {L} layers bf16, B {B}, S {S} ({vcfg.num_prefix_embeds} "
          f"image positions + {n_tokens} tokens) into a decode state, head_mode=last: "
          f"{dt * 1e3:.2f} ms ({B * S / dt:.0f} positions/s); logits {tuple(logits.shape)} "
          f"absmax {scale:.3f}, against the text-only prefill max_abs_diff {diff:.3e}, argmax "
          f"agreement {agree:.2f}; launches {launches}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB before init_params)")
    check(logits.shape == (B, vcfg.vocab_size) and bool(torch.isfinite(logits).all()),
          "[prefill/phi3v] non-finite logits or wrong shape")
    check(launches == want, f"[prefill/phi3v] launches {launches} != {want}")
    check(diff > 1e-3 * scale, "[prefill/phi3v] the image prefix did not change the logits")
    del params, batch, state, logits, text
    torch.cuda.empty_cache()
    return launches


def encode_audio_phase(acfg, dev):
    """[encode/hubert]: full hubert-xlarge (48 layers, bf16, random weights
    from seed 0) encodes B 4 x 1024 frames of seeded frame embeddings,
    non-causal, through the full head.  Gates: finite (B, S, 504) logits
    and one launch of rmsnorm twice and flash attention once a layer (its
    FFN is GELU: no SwiGLU).  Prints the forward's time against its compute
    bound: 2 operations per parameter and frame in the matrix products and
    4 hd per (query, key) pair of the attention, over the bf16 spec-sheet
    peak.  Returns the launches of the gated forward."""
    import torch

    from repro_torch.kernels import KERNELS
    from repro_torch.models import forward, init_params

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    B, S, L = AUDIO["batch"], AUDIO["seq"], acfg.num_layers
    params = init_params(acfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    mm_params = n_params - sum(t.numel() for t in leaves(params) if t.dim() == 1)
    batch = to_device(spec_batch(acfg, B, S, seed=3), dev)
    with torch.no_grad():
        forward(acfg, params, batch)  # warm-up
        torch.cuda.synchronize()
        for kern in KERNELS.values():
            kern.launches = 0
        out, _ = forward(acfg, params, batch)
        torch.cuda.synchronize()
        launches = {n: kern.launches for n, kern in KERNELS.items()}
        ms = time_ms(lambda: forward(acfg, params, batch), reps=3, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    attn_ops = 4 * B * acfg.num_heads * acfg.head_dim * S * S * L
    ops = 2 * mm_params * B * S + attn_ops
    bound_ms = ops / BF16_TENSOR_FLOP_S * 1e3
    want = {n: 0 for n in KERNELS}
    want.update(rmsnorm=2 * L + 1, flash_attention=L)
    print(f"[encode/hubert] {acfg.name} {L} layers d={acfg.d_model} bf16 ({n_params / 1e9:.3f} B "
          f"parameters, {n_params * 2 / 1e9:.2f} GB), B {B} x {S} frames non-causal: forward "
          f"{ms:.2f} ms (CUDA events, mean of 3) against its compute bound {bound_ms:.2f} ms "
          f"({ops / 1e12:.2f} TFLOP, attention {attn_ops / 1e12:.2f}, at "
          f"{BF16_TENSOR_FLOP_S / 1e12:.0f} TFLOP/s): {ms / bound_ms:.2f}x; logits "
          f"{tuple(out.shape)} absmax {float(out.abs().max()):.3f}; launches {launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB before "
          f"init_params)")
    check(out.shape == (B, S, acfg.vocab_size) and bool(torch.isfinite(out).all()),
          "[encode/hubert] non-finite output or wrong shape")
    check(launches == want, f"[encode/hubert] launches {launches} != {want}")
    del params, batch, out
    torch.cuda.empty_cache()
    return launches


def check_phase(dev, cfg, rcfg, zcfg, lcfg, vcfg, acfg):
    """Phase 2: each kernel against its plain version on the card.  Returns
    the largest abs error of each kernel."""
    import torch

    from repro_torch.kernels import KERNELS, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import ROUTES, mamba2_ssd_scan, route
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.swiglu import swiglu
    from repro_torch.kernels.wkv6 import rwkv6_scan

    d, dff, H, Hkv, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rH, rhd = rcfg.d_model // rcfg.ssm.head_dim, rcfg.ssm.head_dim
    B = SERVE["batch_size"]
    randn, wkv6_inputs, ssd_inputs = make_inputs(dev, rcfg, zcfg)
    max_err = {n: 0.0 for n in KERNELS}
    lH, lHkv, lhd = lcfg.num_heads, lcfg.num_kv_heads, lcfg.head_dim
    ssd_routes = set()

    def compare(name, got, want, dtype, label, tol=None):
        torch.cuda.synchronize()
        rtol, atol = tol or TOL[name][str(dtype).split(".")[-1]]
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol))
        ok = ok and bool(torch.isfinite(got.float()).all())
        max_err[name] = max(max_err[name], err)
        print(f"[check/{name}] {label} {str(dtype).split('.')[-1]} max_abs_err={err:.3e} "
              f"(rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label} {dtype}: kernel disagrees with its plain version")

    zH, zhd = zcfg.num_heads, zcfg.head_dim
    for dtype in (torch.bfloat16, torch.float32):
        # decode rows, prefill rows, the training step's rows
        for rows in [B] + [B * s for s in CHECK_S] + [TRAIN["batch"] * TRAIN["seq"]]:
            x = randn(rows, d, dtype=dtype)
            sc = randn(d, dtype=dtype, mul=0.1, add=1.0)
            compare("rmsnorm", rmsnorm(x, sc, eps=cfg.norm_eps),
                    ref.rmsnorm(x, sc, cfg.norm_eps), dtype, f"({rows},{d})")
            g, u = randn(rows, dff, dtype=dtype), randn(rows, dff, dtype=dtype)
            compare("swiglu", swiglu(g, u), ref.swiglu(g, u), dtype, f"({rows},{dff})")
        # llama4-scout's routed experts: the (G, E, C, f) buffer of a decode
        # (G 4, C 1) and of the 445-token prefill (G 20, C 7)
        lf, E = lcfg.moe.d_ff_expert, lcfg.moe.num_experts
        for groups, cap in ((B, 1), (20, 7)):
            g = randn(groups, E, cap, lf, dtype=dtype)
            u = randn(groups, E, cap, lf, dtype=dtype)
            compare("swiglu", swiglu(g, u), ref.swiglu(g, u), dtype,
                    f"llama4 experts (G {groups}, E {E}, C {cap}, f {lf}) = "
                    f"({groups * E * cap},{lf}) rows")
        # rmsnorm at the other serving widths (zamba2, rwkv6, llama4,
        # phi-3-vision, hubert), qk_norm's hd 128 and a d off the 16-byte
        # chunk, at decode and 4 x 445 rows; then an unaligned view (the
        # element-wise path)
        for width in (zcfg.d_model, rcfg.d_model, lcfg.d_model, vcfg.d_model,
                      acfg.d_model, 128, 100):
            for rows in (B, B * 445):
                x = randn(rows, width, dtype=dtype)
                sc = randn(width, dtype=dtype, mul=0.1, add=1.0)
                compare("rmsnorm", rmsnorm(x, sc, eps=cfg.norm_eps),
                        ref.rmsnorm(x, sc, cfg.norm_eps), dtype, f"({rows},{width})")
        x = randn(B * 445 * d + 1, dtype=dtype)[1:].view(B * 445, d)
        sc = randn(d, dtype=dtype, mul=0.1, add=1.0)
        compare("rmsnorm", rmsnorm(x, sc, eps=cfg.norm_eps), ref.rmsnorm(x, sc, cfg.norm_eps),
                dtype, f"({B * 445},{d}) view at an odd element offset")
        cases = [(B, H, Hkv, s, s, hd, True) for s in CHECK_S]
        # the serves' prompt lengths 71 and 445 and short tiles, at granite's
        # GQA rep 4; zamba2's hd 80 at 71; hd 128
        cases += [(B, H, Hkv, s, s, hd, True) for s in (71, 445, 1, 15, 64)]
        cases += [(B, zH, zH, 71, 71, zhd, True), (1, 4, 2, 200, 200, 128, True)]
        cases += [(B, H, Hkv, 200, 328, hd, False)]  # non-causal, ragged S and T
        cases += [(1, 4, 2, 100, 100, e, True) for e in (16, 32, 128)]  # other head dims
        cases += [(B, zH, zH, s, s, zhd, True) for s in (200, 512)]  # zamba2: hd 80, MHA
        cases += [(TRAIN["batch"], H, Hkv, TRAIN["seq"], TRAIN["seq"], hd, True)]  # training
        # llama4-scout's prefill: H 40, Hkv 8 (GQA rep 5), hd 128, at the
        # serve's prompt lengths and the forward check's S 128
        cases += [(B, lH, lHkv, s, s, lhd, True) for s in (445, 71, 128)]
        # phi-3-vision's prefill: MHA, hd 96, at the serve's prompt lengths,
        # the image prefix alone (576), the prefill phase's S 1024 and short
        # tiles; hubert's encoder: non-causal, 16 heads of 80, 1024 frames
        # and a ragged 781
        cases += [(B, vcfg.num_heads, vcfg.num_kv_heads, s, s, vcfg.head_dim, True)
                  for s in (71, 445, 576, 1024, 1, 15)]
        cases += [(B, acfg.num_heads, acfg.num_kv_heads, s, s, acfg.head_dim, False)
                  for s in (1024, 781)]
        for b, h, hk, s, t, e, causal in cases:
            q = randn(b, h, s, e, dtype=dtype, mul=0.5)
            k = randn(b, hk, t, e, dtype=dtype, mul=0.5)
            v = randn(b, hk, t, e, dtype=dtype)
            compare("flash_attention", flash_attention(q, k, v, causal=causal),
                    ref.flash_attention(q, k, v, causal=causal), dtype,
                    f"B={b} H={h} Hkv={hk} S={s} T={t} hd={e} causal={causal}")
        for s in WKV6_CHECK_S:
            args = wkv6_inputs(s, dtype)
            (y, sT), (y_ref, sT_ref) = rwkv6_scan(*args), ref.rwkv6_scan(*args)
            label = f"B={B} H={rH} S={s} hd={rhd}"
            compare("wkv6", y, y_ref, dtype, label + " y")
            compare("wkv6", sT, sT_ref, dtype, label + " state",
                    tol=WKV6_STATE_TOL[str(dtype).split(".")[-1]])
        ssd_cases = [(s, 0, False, False) for s in SSD_CHECK_S] + [(37, 1, False, False)]
        # state None: the kernel's zeros; exact 0 and 1 decays
        ssd_cases += [(s, 0, True, False) for s in (1, 200)]
        ssd_cases += [(s, 0, False, True) for s in SSD_EDGE_S]
        for s, offset, zero_state, edge in ssd_cases:
            args = ssd_inputs(s, dtype, offset, edge)
            if zero_state:
                args = args[:5]
            x = args[0]
            P, N = x.shape[3], args[1].shape[-1]
            kernel = route(s, P, N, dtype)
            ssd_routes.add(kernel)
            y, sT = mamba2_ssd_scan(*args)
            plains = [("", ref.mamba2_ssd_scan)]
            if kernel == "chunked":  # and the plain version of the chunk form
                plains.append((" vs chunked plain", ref.mamba2_ssd_scan_chunked))
            label = (f"B={B} S={s} H={x.shape[2]} P={P} N={N} route={kernel}"
                     f"{' offset 1' if offset else ''}{' zero state' if zero_state else ''}"
                     f"{' decays with exact 0 and 1' if edge else ''}")
            for what, plain in plains:
                y_ref, sT_ref = plain(*args)
                compare("mamba2_ssd", y, y_ref, dtype, label + " y" + what)
                compare("mamba2_ssd", sT, sT_ref, dtype, label + " state" + what)
    check(ssd_routes == set(ROUTES),
          f"mamba2_ssd checks reached the routes {sorted(ssd_routes)}, not all of {ROUTES}")

    def grad_check(name, wrapper, plain, args, dtype, label):
        """The wrapper under grad mode: its output carries a grad_fn, it
        launches once, and its input gradients (the plain version's vjp,
        re-run in the backward) match the plain version's own autograd."""
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        before = KERNELS[name].launches
        with torch.enable_grad():
            out = wrapper(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            fns = sorted({o.grad_fn.name() if o.grad_fn is not None else "none" for o in outs})
            cots = [randn(*o.shape, dtype=o.dtype) for o in outs]
            got = torch.autograd.grad(outs, leaves, cots)
            want_out = plain(*leaves)
            want = torch.autograd.grad(
                want_out if isinstance(want_out, tuple) else (want_out,), leaves, cots)
        torch.cuda.synchronize()
        rtol, atol = TOL[name][str(dtype).split(".")[-1]]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        ok = all(bool(torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol))
                 for g, w in zip(got, want))
        ok = ok and "none" not in fns and KERNELS[name].launches == before + 1
        print(f"[check/grad] {name} {label} {str(dtype).split('.')[-1]}: grad_fn {fns}, "
              f"{len(got)} input gradients, max_abs_err={err:.3e} (rtol={rtol}, "
              f"atol={atol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label} {dtype}: gradient through the kernel wrapper is wrong")

    for dtype in (torch.bfloat16, torch.float32):
        rows = B * 16
        grad_check("rmsnorm", lambda a, s: rmsnorm(a, s, eps=cfg.norm_eps),
                   lambda a, s: ref.rmsnorm(a, s, cfg.norm_eps),
                   [randn(rows, d, dtype=dtype), randn(d, dtype=dtype, mul=0.1, add=1.0)],
                   dtype, f"({rows},{d})")
        grad_check("swiglu", swiglu, ref.swiglu,
                   [randn(rows, dff, dtype=dtype), randn(rows, dff, dtype=dtype)], dtype,
                   f"({rows},{dff})")
        grad_check("flash_attention", flash_attention, ref.flash_attention,
                   [randn(B, H, 71, hd, dtype=dtype, mul=0.5),
                    randn(B, Hkv, 71, hd, dtype=dtype, mul=0.5), randn(B, Hkv, 71, hd, dtype=dtype)],
                   dtype, f"B={B} H={H} Hkv={Hkv} S=T=71 hd={hd} causal")
        vH, vhd = vcfg.num_heads, vcfg.head_dim
        grad_check("flash_attention", flash_attention, ref.flash_attention,
                   [randn(B, vH, 71, vhd, dtype=dtype, mul=0.5),
                    randn(B, vH, 71, vhd, dtype=dtype, mul=0.5),
                    randn(B, vH, 71, vhd, dtype=dtype)],
                   dtype, f"B={B} H={vH} Hkv={vH} S=T=71 hd={vhd} causal")
        grad_check("wkv6", rwkv6_scan, ref.rwkv6_scan, list(wkv6_inputs(37, dtype)), dtype,
                   f"B={B} H={rH} S=37 hd={rhd}")
        grad_check("mamba2_ssd", mamba2_ssd_scan, ref.mamba2_ssd_scan,
                   list(ssd_inputs(37, dtype)), dtype, f"B={B} S=37 zamba2 widths")
    return max_err


def make_inputs(dev, rcfg, zcfg):
    """Input makers of phases 2 and 3, on one generator seeded 0."""
    import torch
    import torch.nn.functional as F

    B = SERVE["batch_size"]
    rH, rhd = rcfg.d_model // rcfg.ssm.head_dim, rcfg.ssm.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype, mul=1.0, add=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * mul + add).to(dtype)

    def wkv6_inputs(S, dtype):
        """r, k, v, the decay by the model's formula (w0 drawn as rwkv6_init
        draws it, plus a data-dependent term: w near 1), u and a non-zero
        initial state."""
        r, k = randn(B, rH, S, rhd, dtype=dtype, mul=0.5), randn(B, rH, S, rhd, dtype=dtype, mul=0.5)
        v = randn(B, rH, S, rhd, dtype=dtype)
        w0 = randn(rH, rhd, dtype=torch.float32, mul=0.1, add=-6.0)
        w_log = w0[None, :, None, :] + randn(B, rH, S, rhd, dtype=torch.float32, mul=0.5)
        w = torch.exp(-torch.exp(w_log)).to(dtype)
        u = randn(rH, rhd, dtype=torch.float32, mul=0.1)
        s0 = randn(B, rH, rhd, rhd, dtype=torch.float32)
        return r, k, v, w, u, s0

    def ssd_inputs(S, dtype, offset=0, edge=False):
        """x, B and C as zamba2's Mamba2 block hands them in: views of one
        (B, S, d_in + 2N) buffer (``offset`` elements into a wider one);
        dt = softplus of a normal draw, as the model makes it from its
        projection and dt_bias 0, and decay = exp(-dt) (a_log 0), with
        ``edge`` exactly 0 at step S // 3 and exactly 1 over the ten steps
        from S // 2; a non-zero f32 initial state."""
        P, N = zcfg.ssm.head_dim, zcfg.ssm.state_dim
        d_in = zcfg.ssm.expand * zcfg.d_model
        zH = d_in // P
        buf = randn(B, S, d_in + 2 * N + offset, dtype=dtype, mul=0.5)[..., offset:]
        x = buf[..., :d_in].reshape(B, S, zH, P)
        Bm, Cm = buf[..., d_in:d_in + N], buf[..., d_in + N:]
        dt = F.softplus(randn(B, S, zH, dtype=torch.float32))
        s0 = randn(B, zH, P, N, dtype=torch.float32)
        decay = torch.exp(-dt)
        if edge:
            decay[:, S // 3] = 0.0
            decay[:, S // 2:S // 2 + 10] = 1.0
        return x, Bm, Cm, decay, dt, s0

    return randn, wkv6_inputs, ssd_inputs


def time_phase(dev, cfg, rcfg, zcfg, vcfg, acfg):
    """Phase 3: kernel, plain version and library call at the largest
    serving shape (bf16).  Returns {name: times and bound}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_scan, route
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.swiglu import swiglu
    from repro_torch.kernels.wkv6 import rwkv6_scan

    d, dff, H, Hkv, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rH, rhd = rcfg.d_model // rcfg.ssm.head_dim, rcfg.ssm.head_dim
    B = SERVE["batch_size"]
    randn, wkv6_inputs, ssd_inputs = make_inputs(dev, rcfg, zcfg)
    bf16, es = torch.bfloat16, 2
    rows = B * TIME_S
    x, sc = randn(rows, d, dtype=bf16), randn(d, dtype=bf16, mul=0.1, add=1.0)
    g, u = randn(rows, dff, dtype=bf16), randn(rows, dff, dtype=bf16)
    rms_lib = ((lambda: F.rms_norm(x, (d,), weight=sc, eps=cfg.norm_eps))
               if hasattr(F, "rms_norm") else None)
    def flash_timed(h, hkv, e, S=TIME_S, causal=True):
        """Flash attention at (B, h, S, e), kv heads hkv, S = T.  Bytes: q, k,
        v read and o written once.  Operations: QK^T and PV over the
        (query, key) pairs the mask keeps (4 e per pair), on the bf16
        tensor cores."""
        q = randn(B, h, S, e, dtype=bf16, mul=0.5)
        k = randn(B, hkv, S, e, dtype=bf16, mul=0.5)
        v = randn(B, hkv, S, e, dtype=bf16)
        pairs = S * (S + 1) // 2 if causal else S * S

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=hkv != h)

        try:
            sdpa()
        except TypeError:  # a torch without enable_gqa has no one-call GQA attention
            sdpa = None
        return dict(
            kernel=lambda: flash_attention(q, k, v, causal=causal),
            plain=lambda: ref.flash_attention(q, k, v, causal=causal), library=sdpa,
            bytes=(2 * B * h * S * e + 2 * B * hkv * S * e) * es,
            ops=4 * B * h * e * pairs, peak=BF16_TENSOR_FLOP_S,
            shape=f"q ({B},{h},{S},{e}) k,v ({B},{hkv},{S},{e}) bf16 "
                  f"{'causal' if causal else 'non-causal'}")

    def wkv6_timed(S):
        """WKV6 at (B, 64, S, 64) bf16.  Bytes: r, k, v, w read and y written
        once, u, and the f32 state read and written.  Operations per step
        and head: y = r.S (2 hd^2), S <- w*S + k v^T (3 hd^2), and the u
        bonus (r*u*k summed, times v, added: 5 hd), f32 on the CUDA cores."""
        args = wkv6_inputs(S, bf16)
        return dict(
            kernel=lambda: rwkv6_scan(*args), plain=lambda: ref.rwkv6_scan(*args),
            library=None,
            bytes=5 * B * rH * S * rhd * es + rH * rhd * 4 + 2 * B * rH * rhd * rhd * 4,
            ops=B * rH * S * (5 * rhd * rhd + 5 * rhd), peak=F32_FLOP_S,
            shape=f"r,k,v,w ({B},{rH},{S},{rhd}) bf16, state f32")

    def ssd_timed(S):
        """The SSD scan at zamba2's widths (B 4, H 80, P 64, N 64), x, B and
        C bf16 views of one (B, S, 5248) buffer, decay, dt and the state
        f32.  Bytes: x, B, C, decay and dt read once, y (f32) written once,
        the state read and written.  Operations, by the form the entry's
        kernel computes: the sequential form (decode) per step and head
        dt*x (P), the outer product with B, the decay multiply and the add
        (3 P N), and y = h C (2 P N), f32 on the CUDA cores; the chunked
        form (prefill) per chunk of L steps and head the bf16 tensor-core
        products G = C B^T (2 L^2 N) and, each with its f32 operand in three
        bf16 terms, M X (3 x 2 L^2 P), C h^T and (X w)^T B (3 x 2 L P N
        each), dense, ragged chunks counted whole."""
        args = ssd_inputs(S, bf16)
        zB, zS, zH, P = args[0].shape
        N = args[1].shape[-1]
        kernel = route(zS, P, N, bf16)
        seq_ops = zB * zS * zH * (5 * P * N + P)
        L = ref.SSD_CHUNK
        chunks = zB * zH * -(-zS // L)
        chunk_ops = chunks * (2 * L * L * N + 3 * 2 * L * L * P + 2 * 3 * 2 * L * P * N)
        if kernel == "chunked":
            ops, peak, other = chunk_ops, BF16_TENSOR_FLOP_S, ("f32 operations of the "
                                                               "sequential form", seq_ops,
                                                               F32_FLOP_S)
        else:
            ops, peak, other = seq_ops, F32_FLOP_S, None
        return dict(
            kernel=lambda: mamba2_ssd_scan(*args), plain=lambda: ref.mamba2_ssd_scan(*args),
            library=None,
            bytes=(zB * zS * zH * P * es + 2 * zB * zS * N * es + 2 * zB * zS * zH * 4
                   + 2 * zB * zH * P * N * 4 + zB * zS * zH * P * 4),
            ops=ops, peak=peak, other=other,
            shape=f"x ({zB},{zS},{zH},{P}) B,C ({zB},{zS},{N}) bf16 views, "
                  f"decay, dt, state f32, route={kernel}")

    timed = {
        "rmsnorm": dict(
            kernel=lambda: rmsnorm(x, sc, eps=cfg.norm_eps),
            plain=lambda: ref.rmsnorm(x, sc, cfg.norm_eps), library=rms_lib,
            bytes=(2 * rows * d + d) * es, ops=4 * rows * d, peak=F32_FLOP_S,
            shape=f"x ({rows},{d}) bf16"),
        "swiglu": dict(
            kernel=lambda: swiglu(g, u), plain=lambda: ref.swiglu(g, u),
            library=lambda: F.silu(g) * u,
            bytes=3 * rows * dff * es, ops=5 * rows * dff, peak=F32_FLOP_S,
            shape=f"gate, up ({rows},{dff}) bf16"),
        "flash_attention": flash_timed(H, Hkv, hd),
        "flash_attention hd80": flash_timed(zcfg.num_heads, zcfg.num_kv_heads, zcfg.head_dim),
        # phi-3-vision's prefill (hd 96) and hubert's encoder (non-causal, S 1024)
        "flash_attention hd96": flash_timed(vcfg.num_heads, vcfg.num_kv_heads, vcfg.head_dim),
        "flash_attention hubert": flash_timed(acfg.num_heads, acfg.num_kv_heads,
                                              acfg.head_dim, S=AUDIO["seq"], causal=False),
        "wkv6": wkv6_timed(TIME_S),
        "wkv6 decode": wkv6_timed(1),
        "mamba2_ssd": ssd_timed(TIME_S),
        "mamba2_ssd decode": ssd_timed(1),
    }
    results = {}
    for name, t in timed.items():
        ms = time_ms(t["kernel"])
        device_ms = graph_ms(t["kernel"])
        plain_ms = time_ms(t["plain"])
        lib = t["library"]
        lib_ms = time_ms(lib) if lib is not None else None
        lib_device_ms = graph_ms(lib) if lib is not None else None
        byte_ms = t["bytes"] / HBM_BYTES_S * 1e3
        op_ms = t["ops"] / t["peak"] * 1e3
        bound_ms = max(byte_ms, op_ms)
        results[name] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             library_device_ms=lib_device_ms, bound_ms=bound_ms,
                             bound_by="bytes" if byte_ms >= op_ms else "operations")
        lib_text = ("none" if lib is None else
                    f"call {lib_ms:.4f} ms device {lib_device_ms:.4f} ms")
        other = ""
        if t.get("other"):
            label, n_ops, rate = t["other"]
            other = f"; {label}: {n_ops} ops, {n_ops / rate * 1e3:.4f} ms, not used"
        print(f"[time/{name}] {t['shape']}: kernel call {ms:.4f} ms device {device_ms:.4f} ms "
              f"(host {ms - device_ms:.4f} ms), plain {plain_ms:.4f} ms, library {lib_text}, "
              f"bound {bound_ms:.4f} ms (bytes: {t['bytes']} B, {byte_ms:.4f} ms; operations: "
              f"{t['ops']} ops at {t['peak'] / 1e12:.0f} TFLOP/s, {op_ms:.4f} ms{other}), "
              f"bound/device {bound_ms / device_ms:.3f} on the "
              f"{results[name]['bound_by']} bound")
    return results


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch missing)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to drive",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, param_count
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import KERNELS, build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = nvidia_smi()
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    t_start = time.perf_counter()

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all(list(KERNELS.values()))
    print(f"[build] {len(KERNELS)} kernels with {build.nvcc_path()} in "
          f"{time.perf_counter() - t0:.1f}s into {build.BUILD_DIR}")
    for name, k in KERNELS.items():
        for line in k.build_log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"[build/{name}] {line.strip()}")

    cfg = get_config("granite-3-2b")
    rcfg = get_config("rwkv6-7b")
    zcfg = get_config("zamba2-2.7b")
    lcfg = get_config("llama4-scout-17b-a16e")
    vcfg = get_config("phi-3-vision-4.2b")
    acfg = get_config("hubert-xlarge")

    # ---- 2. check each kernel against its plain version on the card ---------
    max_err = check_phase(dev, cfg, rcfg, zcfg, lcfg, vcfg, acfg)

    # ---- 3. time at the largest serving shape (bf16) -------------------------
    results = time_phase(dev, cfg, rcfg, zcfg, vcfg, acfg)
    torch.cuda.empty_cache()  # phases 2 and 3 hold no tensor past their return
    print(f"[smoke] {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated before "
          f"the forwards and serves")

    # ---- 4. 2-layer full-width forwards: card (kernels) vs CPU (plain) ------
    none = {n: 0 for n in KERNELS}
    forward_phase("granite", cfg, dev,
                  dict(none, rmsnorm=5, swiglu=2, flash_attention=2))
    forward_phase("rwkv6", rcfg, dev, dict(none, rmsnorm=5, wkv6=2))
    # hybrid_attn_every 2: layer 1 runs the shared block
    forward_phase("zamba2", dataclasses.replace(zcfg, hybrid_attn_every=2), dev,
                  dict(none, rmsnorm=5, swiglu=1, flash_attention=1, mamba2_ssd=2))
    # one llama4-scout layer: SwiGLU for the routed experts and the shared one
    forward_phase("llama4", lcfg, dev, dict(none, rmsnorm=3, swiglu=2, flash_attention=1),
                  layers=1, head_mode="last", draw_on_card=True)
    # phi-3-vision: the 576-position image prefix and 64 text tokens;
    # hubert: frame embeddings, non-causal, a GELU FFN
    forward_phase("phi3v", vcfg, dev, dict(none, rmsnorm=5, swiglu=2, flash_attention=2),
                  shape=(1, vcfg.num_prefix_embeds + 64))
    forward_phase("hubert", acfg, dev, dict(none, rmsnorm=5, flash_attention=2),
                  shape=(2, 256))

    # ---- 5. train: card vs CPU, full granite, the planner, resume -----------
    train_check_phase(cfg, dev)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"]))
    trained, grad_bytes = train_full_phase(
        "granite", cfg, dev,
        [{k: torch.from_numpy(v) for k, v in next(pipe).items()} for _ in range(TRAIN["steps"])])
    plan_phase(grad_bytes)
    train_resume_phase(cfg, dev)
    torch.cuda.empty_cache()
    trained_dp = train_dp_phase(cfg, card)

    # ---- 6. the collective executors: one NCCL rank, 8 gloo ranks ----------
    comms_card_phase(dev)
    comms_gloo8_phase()
    comms_perf_phase()
    fault_card_phase(dev)
    fault_gloo8_phase()
    torch.cuda.empty_cache()

    # ---- 7. the tensor-parallel block: one NCCL rank, 8 gloo ranks ---------
    tp_card_phase(cfg, dev)
    tp_gloo8_phase()

    # ---- 7b. the expert-parallel MoE block: one NCCL rank, 8 gloo ranks ----
    moe_card_phase(lcfg, dev)
    moe_gloo8_phase()

    # ---- 8. serve full granite-3-2b, full rwkv6-7b, full zamba2-2.7b --------
    granite = serve_phase("granite", cfg, dev, lambda L, prefill: dict(
        none, rmsnorm=2 * L + 1, swiglu=L, flash_attention=L if prefill else 0))
    rwkv6 = serve_phase("rwkv6", rcfg, dev, lambda L, prefill: dict(
        none, rmsnorm=2 * L + 1, wkv6=L))
    every = zcfg.hybrid_attn_every
    zamba2 = serve_phase("zamba2", zcfg, dev, lambda L, prefill: dict(
        none, rmsnorm=L + 2 * (L // every) + 1, swiglu=L // every,
        flash_attention=L // every if prefill else 0, mamba2_ssd=L))
    print(f"[serve/llama4] depth cut: {LLAMA4_LAYERS} of {lcfg.num_layers} layers at full "
          f"width (all 48 would hold {param_count(lcfg) * 2 / 1e9:.1f} GB of bf16 weights; "
          f"{LLAMA4_LAYERS} hold "
          f"{param_count(dataclasses.replace(lcfg, num_layers=LLAMA4_LAYERS)) * 2 / 1e9:.1f}"
          f" GB of the card's 80 GB)", flush=True)
    llama4 = serve_phase(
        "llama4", dataclasses.replace(lcfg, num_layers=LLAMA4_LAYERS), dev,
        lambda L, prefill: dict(none, rmsnorm=2 * L + 1, swiglu=2 * L,
                                flash_attention=L if prefill else 0))

    # ---- 9. two granite-3-2b replicas behind a routing policy ---------------
    cluster = cluster_card_phase(cfg, dev)

    # ---- 10. the vlm and audio families ---------------------------------------
    vlm_prefill = prefill_vlm_phase(vcfg, dev)
    phi3v = serve_phase("phi3v", vcfg, dev, lambda L, prefill: dict(
        none, rmsnorm=2 * L + 1, swiglu=L, flash_attention=L if prefill else 0))
    encoded = encode_audio_phase(acfg, dev)
    audio_trained, _ = train_full_phase(
        "hubert", acfg, dev, [spec_batch(acfg, AUDIO["batch"], AUDIO["seq"], "train", seed=s)
                              for s in range(AUDIO["train_steps"])])

    # ---- result --------------------------------------------------------------
    kernels = []
    for name in KERNELS:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{KERNELS[name].source}",
            "replaces": REPLACES[name],
            "launches": (trained[name] + trained_dp[name] + granite[name] + rwkv6[name]
                         + zamba2[name]
                         + llama4[name] + cluster[name] + vlm_prefill[name] + phi3v[name]
                         + encoded[name] + audio_trained[name]),
            "max_abs_err": max_err[name], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
        })
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)  # name, power limit: as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
