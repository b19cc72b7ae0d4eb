"""Batched serving runtime: continuous batching over a fixed slot pool.

The counterpart of ``repro/runtime/server.py``, with the same semantics
step for step, so both packages emit the same token streams from the same
weights and prompts:

* requests queue up; the server keeps ``batch_size`` decode slots and
  refills a free slot from the queue before every engine step;
* prefill runs the prompt batched across the full slot dimension (the
  other lanes hold zeros) and keeps only that slot's lane of the new
  state, its argmax being the request's first token.  A recurrent prefill
  (ssm, and the Mamba2 layers of a hybrid) starts from the live decode
  state, as the reference's does: the slot's ``wkv``, ``tmix_x`` and
  ``cmix_x``, or its ``conv`` and ``ssm``, carry into the prompt;
* an engine step decodes one micro-batch per distinct slot position, each
  at that position, for every lane.

The reference's schedule has three defects (ROADMAP queue C) that the port
mirrors token for token: a lane that is further along gets another
micro-batch's K/V written at a position of its history; a recurrent lane in
a later micro-batch is advanced again with the same pending token; and a
refilled recurrent slot starts its prompt from the previous request's final
state and whatever idle decodes wrote there.  A hybrid (zamba2) has both a
K/V cache and a recurrent state, and inherits all three.

Every request carries a :class:`RequestTiming` record on the server's
``clock``, reported per request by :meth:`BatchedServer.drain_report`.
Timestamps follow a host synchronisation (each argmax is read back to the
host), so they measure the device's work.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import decode_step, forward, init_decode_state

__all__ = ["ServerConfig", "BatchedServer", "RequestTiming"]

#: decode-state leaves that are K/V caches, (layers, B, Hkv, T, hd); every
#: other leaf is recurrent state
_KV_LEAVES = ("k", "v", "shared_k", "shared_v")


@dataclass(frozen=True)
class ServerConfig:
    batch_size: int = 4
    max_seq: int = 128
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: disabled (synthetic vocab has no real EOS)


@dataclass
class RequestTiming:
    """Per-request phase timestamps on the server's clock (seconds).

    ``decode_start_s`` stays None for single-token requests (the prefill
    emits token 1, so a ``max_new_tokens=1`` request never decodes)."""

    rid: int
    prompt_tokens: int
    enqueue_s: float
    prefill_start_s: Optional[float] = None
    prefill_done_s: Optional[float] = None
    decode_start_s: Optional[float] = None
    finish_s: Optional[float] = None
    generated: int = 0

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finish_s is None else self.finish_s - self.enqueue_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (the prefill's argmax is token 1)."""
        if self.prefill_done_s is None:
            return None
        return self.prefill_done_s - self.enqueue_s

    @property
    def queue_s(self) -> Optional[float]:
        if self.prefill_start_s is None:
            return None
        return self.prefill_start_s - self.enqueue_s

    def to_json(self) -> Dict[str, Any]:
        return {
            "rid": self.rid, "prompt_tokens": self.prompt_tokens,
            "enqueue_s": self.enqueue_s,
            "prefill_start_s": self.prefill_start_s,
            "prefill_done_s": self.prefill_done_s,
            "decode_start_s": self.decode_start_s,
            "finish_s": self.finish_s, "generated": self.generated,
        }


@dataclass
class _Slot:
    request_id: Optional[int] = None
    pos: int = 0
    generated: List[int] = field(default_factory=list)


def _tree_map(tree: Dict, fn: Callable[[torch.Tensor], torch.Tensor]) -> Dict:
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tree_zip(fn: Callable[[torch.Tensor, torch.Tensor], None], a: Dict, b: Dict) -> None:
    for k, v in a.items():
        if isinstance(v, dict):
            _tree_zip(fn, v, b[k])
        else:
            fn(v, b[k])


def _percentile(vals: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), p)) if vals else 0.0


class BatchedServer:
    """Continuous-batching server over the port's decoders: dense, MoE,
    rwkv6, zamba2 and the vision model, which it serves on tokens alone, as
    the reference's does (no ``image_embeds``).  An encoder-only model
    (hubert) has no autoregressive decode and is refused.

    ``params`` must lie on ``device`` (``cuda`` unless the caller passes
    another device; the constructor raises if CUDA is asked for and absent).
    """

    def __init__(self, cfg: ModelConfig, params: Dict, scfg: ServerConfig, *,
                 device: Union[str, torch.device, None] = "cuda",
                 clock: Callable[[], float] = time.perf_counter):
        self.device = resolve_device(device)
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: it has no autoregressive decode "
                             f"to serve")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, server on {self.device}")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.clock = clock
        self.queue: collections.deque = collections.deque()
        self.results: Dict[int, List[int]] = {}
        self.records: Dict[int, RequestTiming] = {}
        self._fresh_state()

    def _fresh_state(self) -> None:
        self._next_id = 0
        self.slots = [_Slot() for _ in range(self.scfg.batch_size)]
        self.state = init_decode_state(self.cfg, self.scfg.batch_size, self.scfg.max_seq,
                                       device=self.device)
        self._tokens = np.zeros((self.scfg.batch_size, 1), np.int64)

    # ---- API -------------------------------------------------------------
    def submit(self, prompt: np.ndarray) -> int:
        rid = self._next_id
        self._next_id += 1
        prompt = np.asarray(prompt, np.int64)
        self.queue.append((rid, prompt))
        self.records[rid] = RequestTiming(
            rid=rid, prompt_tokens=len(prompt), enqueue_s=self.clock())
        return rid

    def reset(self) -> None:
        """Return the server to its just-constructed state: drain in-flight
        work (finishing it rather than abandoning slots mid-decode), then
        clear the queue, results, timing records and the request-id counter,
        and zero the decode state."""
        if self.pending_work():
            self.run_until_drained()
        self.queue.clear()
        self.results.clear()
        self.records.clear()
        self._fresh_state()

    def active_count(self) -> int:
        """Occupied decode slots."""
        return sum(1 for s in self.slots if s.request_id is not None)

    def pending_work(self) -> bool:
        return bool(self.queue) or self.active_count() > 0

    @torch.no_grad()
    def _prefill_into_slot(self, slot_idx: int, rid: int, prompt: np.ndarray) -> None:
        """Run the prompt through the model, writing this slot's state."""
        rec = self.records[rid]
        rec.prefill_start_s = self.clock()
        S = len(prompt)
        # the prompt batched across the full slot dim; only slot_idx's lane
        # of the new state is kept (_merge_slot)
        toks = np.zeros((self.scfg.batch_size, S), np.int64)
        toks[slot_idx] = prompt
        logits, scratch = forward(self.cfg, self.params,
                                  {"tokens": torch.from_numpy(toks).to(self.device)},
                                  cache=self._prefill_scratch(S), cache_pos=0)
        self._merge_slot(scratch, slot_idx)
        nxt = int(torch.argmax(logits[slot_idx, -1]))
        slot = self.slots[slot_idx]
        slot.request_id = rid
        slot.pos = S
        slot.generated = [nxt]
        self._tokens[slot_idx, 0] = nxt
        rec.prefill_done_s = self.clock()
        rec.generated = 1
        if self.scfg.max_new_tokens <= 1 or nxt == self.scfg.eos_id:
            self._finish_slot(slot_idx)

    def _prefill_scratch(self, S: int) -> Dict:
        """The state an S-token prefill runs on.  The reference prefills
        from the live state (``self.state``).  Recurrent leaves are copied
        from it (forward writes every lane in place, and only the slot's
        lane is kept), so a hybrid copies its Mamba2 state, about 0.29 GB
        at zamba2-2.7b's width and batch 4.  K/V leaves are S-long zeros
        instead of a copy of the max_seq-long cache (0.38 GB for zamba2):
        prefill attention reads only the prompt's own K/V, and
        ``_merge_slot`` installs positions [0, S) of the slot's lane and
        keeps the rest, which is what the reference's merge of its
        full-length cache leaves there.  The tokens are the same either
        way."""

        def fresh(key: str, live: Any) -> Any:
            if key in _KV_LEAVES:
                return live.new_zeros(live.shape[:3] + (S,) + live.shape[4:])
            return _tree_map(live, torch.clone) if isinstance(live, dict) else live.clone()

        return {k: fresh(k, v) for k, v in self.state.items()}

    def _finish_slot(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        rec = self.records[slot.request_id]
        rec.finish_s = self.clock()
        rec.generated = len(slot.generated)
        self.results[slot.request_id] = slot.generated
        self.slots[slot_idx] = _Slot()

    def _merge_slot(self, prefill_state: Dict, slot_idx: int) -> None:
        """Install this slot's lane of a prefill's state, as the reference's
        ``_merge_slot`` does; every leaf has the batch dim right after the
        layer dim.  A leaf of the live state's shape (the recurrent state)
        has the slot's whole lane replaced.  A prefill K/V cache is only S
        positions long: positions [0, S) of the lane are replaced and the
        rest of the lane is kept.  The other lanes are kept."""

        def merge(live: torch.Tensor, new: torch.Tensor) -> None:
            if new.shape == live.shape:
                live[:, slot_idx] = new[:, slot_idx]
            else:
                live[:, slot_idx, :, :new.shape[3]] = new[:, slot_idx]

        _tree_zip(merge, self.state, prefill_state)

    def _refill(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.request_id is None and self.queue:
                rid, prompt = self.queue.popleft()
                self._prefill_into_slot(i, rid, prompt)

    @torch.no_grad()
    def engine_step(self) -> None:
        self._refill()
        active = [i for i, s in enumerate(self.slots) if s.request_id is not None]
        if not active:
            return
        # one micro-batch per distinct slot position, each decoding every
        # lane at that position (the reference's schedule, kept as it is)
        by_pos: Dict[int, List[int]] = {}
        for i in active:
            by_pos.setdefault(self.slots[i].pos, []).append(i)
        for pos, idxs in sorted(by_pos.items()):
            step_start = self.clock()
            tokens = torch.from_numpy(self._tokens).to(self.device)
            logits, self.state = decode_step(self.cfg, self.params, self.state, tokens, pos)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for i in idxs:
                slot = self.slots[i]
                rec = self.records[slot.request_id]
                if rec.decode_start_s is None:
                    rec.decode_start_s = step_start
                tok = int(nxt[i])
                slot.generated.append(tok)
                slot.pos += 1
                self._tokens[i, 0] = tok
                rec.generated = len(slot.generated)
                done = (
                    len(slot.generated) >= self.scfg.max_new_tokens
                    or tok == self.scfg.eos_id
                    or slot.pos >= self.scfg.max_seq - 1
                )
                if done:
                    self._finish_slot(i)

    def run_until_drained(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        steps = 0
        while self.pending_work():
            self.engine_step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("server did not drain")
        return self.results

    def drain_report(self) -> Dict[str, Any]:
        """Per-request timestamps plus aggregate latency/throughput stats
        for every finished request (the reference's keys)."""
        done = [r for r in self.records.values() if r.finish_s is not None]
        lat = [r.latency_s for r in done]
        ttft = [r.ttft_s for r in done if r.ttft_s is not None]
        toks = sum(r.generated for r in done)
        span = (max(r.finish_s for r in done) - min(r.enqueue_s for r in done)
                if done else 0.0)
        return {
            "requests": len(done),
            "tokens": toks,
            "makespan_s": span,
            "throughput_tok_s": (toks / span) if span > 0 else 0.0,
            "latency_p50_s": _percentile(lat, 50),
            "latency_p99_s": _percentile(lat, 99),
            "ttft_p50_s": _percentile(ttft, 50),
            "per_request": [r.to_json() for r in sorted(done, key=lambda r: r.rid)],
        }
