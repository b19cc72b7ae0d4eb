"""Event-driven cluster serving simulator.

A copy of ``repro/cluster/sim.py`` (numpy only), held equal to it by
``tests/test_torch_cluster.py``; its replicas default to the H100 data
sheet's peaks (``launch.roofline``) where the reference's take a TPU's.

Models N model replicas behind a routing policy under an arrival trace,
in the ragx ``Interconnect``/stats idiom: one event heap, per-link FIFO
transmission, per-replica continuous-batching slot pools, and a
:class:`ClusterStats` record mirroring the measured drain report of
``runtime.server.BatchedServer`` field-for-field.

The physics come from the models the stack already has:

* **transmission** — every client→replica prompt transfer is priced by
  ``core.cost_model.transfer_time`` under either the electrical
  ``LinkSpec`` world (``α + d/B``) or the paper's optical Eq.-3 world
  (``d/B + a`` per step), with per-link FIFO contention;
* **compute** — per-request prefill and per-engine-step decode times come
  from the roofline phase queries (``launch.roofline.prefill_time_s`` /
  ``decode_step_time_s``) baked into each :class:`ReplicaSpec`.

Replica engine semantics mirror ``BatchedServer`` exactly: prefill is
per-request and blocking (refill-first), each decode step emits one token
for every active slot, the prefill itself emits token 1, and a finished
slot refills from the queue before the next decode step.  That mirroring
is what lets the simulator's latency distribution be validated against
the measured one (``cluster.frontend``).

Determinism: the heap orders events ``(time, seq)`` with ``seq`` a
monotone push counter, and every service/transmission time is a pure
function of the trace and specs — the same seeded trace replays a
bit-identical ``event_log``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.cost_model import OpticalSystem, transfer_time
from ..core.planner import ICI_LINK, LinkSpec
from .traces import Request

__all__ = ["ReplicaSpec", "RequestRecord", "ClusterStats", "ClusterSim",
           "BYTES_PER_TOKEN"]

BYTES_PER_TOKEN = 4  # int32 token ids on the wire


# --------------------------------------------------------------------------
# replica model
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ReplicaSpec:
    """One model replica's serving physics: slot pool width, the roofline
    terms behind its phase times, and its ingress link.

    ``prefill_time_s``/``decode_step_time_s`` are the two-term roofline
    max (compute against ``peak_flops``, one weight-streaming pass against
    ``hbm_bw``) — :meth:`from_config` fills the terms from a
    ``ModelConfig`` via ``launch.roofline``; :meth:`from_times` pins them
    to measured per-token/per-step seconds (the calibration path the
    front end uses for simulated-vs-measured validation).
    """

    name: str
    batch_size: int
    flops_per_token: float      # 2 · N_active
    weight_bytes: float         # streamed once per engine step / prefill
    peak_flops: float = 989e12  # launch.roofline.PEAK_FLOPS (H100 bf16, spec sheet)
    hbm_bw: float = 3.35e12     # launch.roofline.HBM_BW (H100 HBM3, spec sheet)
    chips: int = 1
    link: LinkSpec = ICI_LINK

    @staticmethod
    def from_config(name: str, cfg, batch_size: int, *,
                    link: LinkSpec = ICI_LINK, chips: int = 1,
                    peak_flops: Optional[float] = None,
                    hbm_bw: Optional[float] = None) -> "ReplicaSpec":
        from ..configs import active_param_count
        from ..launch.roofline import HBM_BW, PEAK_FLOPS, _weight_bytes

        return ReplicaSpec(
            name=name, batch_size=batch_size,
            flops_per_token=2.0 * active_param_count(cfg),
            weight_bytes=_weight_bytes(cfg),
            peak_flops=peak_flops if peak_flops else PEAK_FLOPS,
            hbm_bw=hbm_bw if hbm_bw else HBM_BW,
            chips=chips, link=link)

    @staticmethod
    def from_times(name: str, batch_size: int, *, prefill_token_s: float,
                   decode_step_s: float,
                   link: LinkSpec = ICI_LINK) -> "ReplicaSpec":
        """Pin the phase times to measured seconds: prefill is linear at
        ``prefill_token_s`` per prompt token (with the decode step as its
        floor), one decode step costs ``decode_step_s`` regardless of the
        active count (the memory-bound regime — exactly what a host-mesh
        calibration observes)."""
        return ReplicaSpec(
            name=name, batch_size=batch_size,
            flops_per_token=prefill_token_s, weight_bytes=decode_step_s,
            peak_flops=1.0, hbm_bw=1.0, chips=1, link=link)

    def prefill_time_s(self, prompt_tokens: int) -> float:
        return max(self.flops_per_token * prompt_tokens / self.chips
                   / self.peak_flops,
                   self.weight_bytes / self.chips / self.hbm_bw)

    def decode_step_time_s(self, active: int = 1) -> float:
        return max(self.flops_per_token * active / self.chips
                   / self.peak_flops,
                   self.weight_bytes / self.chips / self.hbm_bw)

    def request_service_s(self, req: Request) -> float:
        """Single-request service estimate: prefill + its solo decode
        chain (the prefill emits token 1, so ``new_tokens - 1`` steps)."""
        return (self.prefill_time_s(req.prompt_tokens)
                + max(0, req.new_tokens - 1) * self.decode_step_time_s(1))


# --------------------------------------------------------------------------
# records + stats (shared with the measured front end)
# --------------------------------------------------------------------------

@dataclass
class RequestRecord:
    """One request's phase timestamps — the simulator's twin of
    ``runtime.server.RequestTiming`` plus the routing fields."""

    rid: int
    replica: str
    prompt_tokens: int
    new_tokens: int
    arrival_s: float
    enqueue_s: Optional[float] = None   # transmission done, queued at replica
    prefill_start_s: Optional[float] = None
    prefill_done_s: Optional[float] = None
    decode_start_s: Optional[float] = None
    finish_s: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finish_s is None else self.finish_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.prefill_done_s is None:
            return None
        return self.prefill_done_s - self.arrival_s

    @property
    def queue_s(self) -> Optional[float]:
        if self.prefill_start_s is None or self.enqueue_s is None:
            return None
        return self.prefill_start_s - self.enqueue_s

    def to_json(self) -> dict:
        return {
            "rid": self.rid, "replica": self.replica,
            "prompt_tokens": self.prompt_tokens,
            "new_tokens": self.new_tokens,
            "arrival_s": self.arrival_s, "enqueue_s": self.enqueue_s,
            "prefill_start_s": self.prefill_start_s,
            "prefill_done_s": self.prefill_done_s,
            "decode_start_s": self.decode_start_s,
            "finish_s": self.finish_s,
        }


def _percentile(vals: Sequence[float], p: float) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), p)) if vals else 0.0


@dataclass
class ClusterStats:
    """Latency / throughput / utilization breakdowns over one run.

    Built by the simulator AND by the measured front end from the same
    :class:`RequestRecord` rows, so simulated and measured distributions
    compare field-for-field (the validation methodology in
    ``docs/serving.md``)."""

    records: List[RequestRecord] = field(default_factory=list)
    makespan_s: float = 0.0
    busy_s: Dict[str, float] = field(default_factory=dict)      # per replica
    tx_busy_s: Dict[str, float] = field(default_factory=dict)   # per link
    routed: Dict[str, int] = field(default_factory=dict)        # per replica

    @property
    def latencies_s(self) -> List[float]:
        return [r.latency_s for r in self.records if r.finish_s is not None]

    def latency_p50_s(self) -> float:
        return _percentile(self.latencies_s, 50)

    def latency_p99_s(self) -> float:
        return _percentile(self.latencies_s, 99)

    def ttft_p50_s(self) -> float:
        vals = [r.ttft_s for r in self.records if r.ttft_s is not None]
        return _percentile(vals, 50)

    def total_tokens(self) -> int:
        return sum(r.new_tokens for r in self.records
                   if r.finish_s is not None)

    def throughput_tok_s(self) -> float:
        return self.total_tokens() / self.makespan_s if self.makespan_s else 0.0

    def utilization(self) -> Dict[str, float]:
        if not self.makespan_s:
            return {k: 0.0 for k in self.busy_s}
        return {k: v / self.makespan_s for k, v in self.busy_s.items()}

    def to_json(self) -> dict:
        return {
            "requests": len(self.records),
            "tokens": self.total_tokens(),
            "makespan_s": self.makespan_s,
            "throughput_tok_s": self.throughput_tok_s(),
            "latency_p50_s": self.latency_p50_s(),
            "latency_p99_s": self.latency_p99_s(),
            "ttft_p50_s": self.ttft_p50_s(),
            "utilization": self.utilization(),
            "tx_busy_s": dict(self.tx_busy_s),
            "routed": dict(self.routed),
            "per_request": [r.to_json() for r in
                            sorted(self.records, key=lambda r: r.rid)],
        }

    def summary(self) -> str:
        util = " ".join(f"{k}={v:.2f}" for k, v in
                        sorted(self.utilization().items()))
        routed = " ".join(f"{k}={v}" for k, v in sorted(self.routed.items()))
        return (f"req={len(self.records)} tok={self.total_tokens()} "
                f"makespan={self.makespan_s * 1e3:.2f}ms "
                f"p50={self.latency_p50_s() * 1e3:.2f}ms "
                f"p99={self.latency_p99_s() * 1e3:.2f}ms "
                f"tput={self.throughput_tok_s():.0f}tok/s "
                f"util[{util}] routed[{routed}]")


# --------------------------------------------------------------------------
# the simulator
# --------------------------------------------------------------------------

class _Replica:
    """Mutable per-replica simulation state (one BatchedServer analogue)."""

    def __init__(self, index: int, spec: ReplicaSpec):
        self.index = index
        self.spec = spec
        self.queue: List[int] = []          # rids awaiting a slot
        self.active: Dict[int, int] = {}    # rid -> decode steps remaining
        self.busy = False
        self.busy_until = 0.0
        self.busy_s = 0.0
        self.link_free_at = 0.0
        self.tx_busy_s = 0.0

    def backlog_s(self, now: float, reqs: Dict[int, Request]) -> float:
        """Estimated seconds of committed work ahead of a new arrival:
        the in-flight engine phase, every queued request's solo service,
        and the active slots' remaining decode steps."""
        t = max(0.0, self.busy_until - now) if self.busy else 0.0
        for rid in self.queue:
            t += self.spec.request_service_s(reqs[rid])
        if self.active:
            t += max(self.active.values()) * self.spec.decode_step_time_s(
                len(self.active))
        return t


class ClusterSim:
    """Event-driven simulation of N replicas behind one routing policy.

    ``world`` picks the transmission pricing backend: ``"electrical"``
    prices each client→replica hop with the replica's ``LinkSpec``,
    ``"optical"`` with Eq. 3 on ``optical`` (default TERARACK) — the same
    two cost worlds every collective in the stack plans against.
    """

    def __init__(
        self,
        replicas: Sequence[ReplicaSpec],
        policy,
        *,
        world: str = "electrical",
        optical: Optional[OpticalSystem] = None,
        bytes_per_token: int = BYTES_PER_TOKEN,
    ):
        if world not in ("electrical", "optical"):
            raise ValueError(f"world must be electrical|optical, got {world!r}")
        if not replicas:
            raise ValueError("need at least one ReplicaSpec")
        self.specs = list(replicas)
        self.policy = policy
        self.world = world
        self.optical = optical
        self.bytes_per_token = bytes_per_token
        self.event_log: List[tuple] = []

    # -- pricing -----------------------------------------------------------
    def _tx_model(self, spec: ReplicaSpec):
        if self.world == "optical":
            from ..core.cost_model import TERARACK
            return self.optical if self.optical is not None else TERARACK
        return spec.link

    def tx_time_s(self, spec: ReplicaSpec, nbytes: float) -> float:
        return transfer_time(self._tx_model(spec), nbytes)

    # -- run ---------------------------------------------------------------
    def run(self, trace: Sequence[Request]) -> ClusterStats:
        from .scheduler import ReplicaView  # lazy: scheduler imports us

        reqs = {r.rid: r for r in trace}
        recs: Dict[int, RequestRecord] = {}
        reps = [_Replica(i, s) for i, s in enumerate(self.specs)]
        routed = {s.name: 0 for s in self.specs}
        heap: List[tuple] = []
        seq = 0
        self.event_log = []

        def push(t: float, kind: str, *payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        def views(now: float) -> List["ReplicaView"]:
            out = []
            for r in reps:
                spec = r.spec
                out.append(ReplicaView(
                    index=r.index, spec=spec,
                    queue_len=len(r.queue), active=len(r.active),
                    backlog_s=r.backlog_s(now, reqs),
                    link_free_in_s=max(0.0, r.link_free_at - now),
                    tx_time_s=lambda nb, s=spec: self.tx_time_s(s, nb),
                ))
            return out

        def route(batch: List[Request], now: float):
            picks = self.policy.route_batch(batch, views(now), now)
            for req, ridx in zip(batch, picks):
                r = reps[ridx]
                routed[r.spec.name] += 1
                recs[req.rid] = RequestRecord(
                    rid=req.rid, replica=r.spec.name,
                    prompt_tokens=req.prompt_tokens,
                    new_tokens=req.new_tokens, arrival_s=req.arrival_s)
                nbytes = req.prompt_tokens * self.bytes_per_token
                start = max(now, r.link_free_at)
                tx = self.tx_time_s(r.spec, nbytes)
                r.link_free_at = start + tx
                r.tx_busy_s += tx
                push(start + tx, "enqueue", req.rid, r.index)
                self.event_log.append((now, "route", req.rid, r.index))

        def kick(r: _Replica, now: float):
            """Start the replica's next engine phase if it is idle —
            refill-first (prefill) then one decode step, exactly the
            BatchedServer.engine_step order."""
            if r.busy:
                return
            if r.queue and len(r.active) < r.spec.batch_size:
                rid = r.queue.pop(0)
                rec = recs[rid]
                rec.prefill_start_s = now
                dt = r.spec.prefill_time_s(rec.prompt_tokens)
                r.busy, r.busy_until = True, now + dt
                r.busy_s += dt
                push(now + dt, "prefill_done", rid, r.index)
                self.event_log.append((now, "prefill_start", rid, r.index))
                return
            if r.active:
                dt = r.spec.decode_step_time_s(len(r.active))
                r.busy, r.busy_until = True, now + dt
                r.busy_s += dt
                push(now + dt, "step_done", r.index)
                self.event_log.append((now, "decode_step", r.index,
                                       len(r.active)))

        # arrivals sharing one instant route as one batch (the max-flow
        # policy's placement window; singleton batches for everyone else)
        i, n = 0, len(trace)
        while i < n:
            j = i + 1
            while j < n and trace[j].arrival_s == trace[i].arrival_s:
                j += 1
            push(trace[i].arrival_s, "arrivals", tuple(trace[i:j]))
            i = j

        finished = 0
        end = 0.0
        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            if kind == "arrivals":
                route(list(payload[0]), now)
            elif kind == "enqueue":
                rid, ridx = payload
                r = reps[ridx]
                recs[rid].enqueue_s = now
                r.queue.append(rid)
                self.event_log.append((now, "enqueue", rid, ridx))
                kick(r, now)
            elif kind == "prefill_done":
                rid, ridx = payload
                r = reps[ridx]
                r.busy = False
                rec = recs[rid]
                rec.prefill_done_s = now
                remaining = reqs[rid].new_tokens - 1  # prefill emits token 1
                if remaining <= 0:
                    rec.finish_s = now
                    finished += 1
                    end = max(end, now)
                    self.event_log.append((now, "finish", rid, ridx))
                else:
                    r.active[rid] = remaining
                self.event_log.append((now, "prefill_done", rid, ridx))
                kick(r, now)
            elif kind == "step_done":
                (ridx,) = payload
                r = reps[ridx]
                r.busy = False
                done_rids = []
                for rid in list(r.active):
                    rec = recs[rid]
                    if rec.decode_start_s is None:
                        rec.decode_start_s = r.busy_until - \
                            r.spec.decode_step_time_s(len(r.active))
                    r.active[rid] -= 1
                    if r.active[rid] <= 0:
                        done_rids.append(rid)
                for rid in done_rids:
                    del r.active[rid]
                    recs[rid].finish_s = now
                    finished += 1
                    end = max(end, now)
                    self.event_log.append((now, "finish", rid, ridx))
                self.event_log.append((now, "step_done", ridx, len(done_rids)))
                kick(r, now)
            else:  # pragma: no cover — no other kinds are pushed
                raise AssertionError(f"unknown event {kind}")

        if finished != len(trace):  # pragma: no cover — invariant
            raise RuntimeError(
                f"simulation drained {finished}/{len(trace)} requests")
        return ClusterStats(
            records=[recs[r.rid] for r in trace],
            makespan_s=end,
            busy_s={r.spec.name: r.busy_s for r in reps},
            tx_busy_s={r.spec.name: r.tx_busy_s for r in reps},
            routed=routed,
        )
