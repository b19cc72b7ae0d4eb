"""A world of ranks for the launchers: ``run_world`` spawns one process a
rank, each of which joins the ``torch.distributed`` world and runs one
function.

    run_world(8, "cpu", fn, {"x": 1})   # fn(device, x=1) on each of 8 ranks

The ranks meet through a ``FileStore`` in a fresh temporary directory
(never a TCP port).  On ``cpu`` each rank is a gloo process with one
thread; on ``cuda`` an NCCL rank a card (``comms.init_world`` refuses a
world larger than the card count).  A rank that fails exits at once, the
rest are killed, and ranks still running at the deadline are killed too.
``launch.perf`` and ``launch.train --mesh`` both run through it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, Dict

__all__ = ["WORLD_TIMEOUT_S", "run_world"]

#: a world whose ranks hang is killed after this long
WORLD_TIMEOUT_S = 1200.0


def _rank_main(rank, world, store, device, target, kwargs, result_path):
    """One rank: join the world, run ``target(dev, **kwargs)``, and on rank 0
    pickle what it returned to ``result_path``."""
    import torch
    import torch.distributed as dist

    from repro_torch.comms import init_world

    if device == "cpu":
        torch.set_num_threads(1)
    try:
        dev = init_world(device, world_size=world, rank=rank, store_path=store)
        out = target(dev, **kwargs)
        dist.barrier()
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # do not wait on peers that will never answer
    sys.stdout.flush()
    dist.destroy_process_group()


def run_world(world: int, device: str, target: Callable, kwargs: Dict[str, Any],
              timeout_s: float = WORLD_TIMEOUT_S, name: str = "world") -> Any:
    """Spawn ``world`` ranks each running ``target(dev, **kwargs)`` (a
    module-level function), wait at most ``timeout_s`` and kill whatever
    is left; raise unless every rank exited 0.  Returns rank 0's result."""
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "result.pkl")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "store"), device,
                                   target, kwargs, result_path))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            pending = list(procs)
            while pending and time.monotonic() < deadline:
                wait([p.sentinel for p in pending], deadline - time.monotonic())
                pending = [p for p in pending if p.exitcode is None]
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # one rank failed: the rest are killed below
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"{name}: rank exit codes {codes} "
                               f"(None: killed after {timeout_s} s)")
        with open(result_path, "rb") as f:
            return pickle.load(f)
