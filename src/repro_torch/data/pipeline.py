"""Deterministic synthetic LM data pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only): the same (seed, step)
gives the same batch in both packages.

Production-shaped: per-host sharding (each host materializes only its slice
of the global batch), background prefetch, and a checkpointable iterator
state (`state()` / `restore()`) so a restarted job resumes mid-epoch on the
exact batch it crashed before.

Tokens are a Zipf-ish mixture with a Markov flavour derived from a counter-
based hash — reproducible from (seed, step) alone, no files needed offline.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLMPipeline"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


class SyntheticLMPipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self._step = 0
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- deterministic batch synthesis ------------------------------------
    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        local_b = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(
            np.uint64(cfg.seed) * np.uint64(1_000_003)
            + np.uint64(step) * np.uint64(cfg.num_hosts)
            + np.uint64(cfg.host_id)
        )
        # zipf-flavoured unigram + short repeats to give the LM signal
        base = rng.zipf(1.3, size=(local_b, cfg.seq_len + 1)).astype(np.int64)
        tokens = (base % (cfg.vocab_size - 2)) + 1
        # inject periodic structure: every 7th token repeats the 3rd-previous
        tokens[:, 7::7] = tokens[:, 4:-3:7] if cfg.seq_len >= 8 else tokens[:, 7::7]
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    # ---- iterator protocol with prefetch ----------------------------------
    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def start(self):
        if self._thread is None:
            self._q = queue.Queue(maxsize=self.cfg.prefetch)
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2)
            self._thread = None
            self._q = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is not None:
            while True:
                step, batch = self._q.get()
                if step == self._step:  # drop stale prefetches after restore
                    break
        else:
            batch = self._batch_at(self._step)
        self._step += 1
        return batch

    # ---- checkpointable state ----------------------------------------------
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.cfg.seed}

    def restore(self, state: Dict):
        if state.get("seed") != self.cfg.seed:
            raise ValueError("restoring a pipeline with a different seed")
        was_running = self._thread is not None
        self.stop()
        self._step = int(state["step"])
        if was_running:
            self.start()
