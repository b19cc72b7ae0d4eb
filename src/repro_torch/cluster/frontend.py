"""Multi-replica serving front end: N ``BatchedServer``s behind a policy.

The port of ``repro/cluster/frontend.py`` over the port's
``runtime.server.BatchedServer``.  :class:`ClusterServer` is the measured
twin of ``cluster.sim.ClusterSim``: the same
:class:`~repro_torch.cluster.scheduler.Policy` objects route real requests
onto real ``BatchedServer`` replicas, every request keeps its measured
phase timestamps (``runtime.server.RequestTiming``), and
:meth:`ClusterServer.drain_report` assembles them into the same
:class:`~repro_torch.cluster.sim.ClusterStats` shape the simulator emits,
so simulated and measured latency distributions compare field for field.
The server reads each step's tokens back to the host, so its timestamps
follow a host synchronisation and measure the device's work.

Replicas step round-robin on the host (one process; on one card their
kernels run one after another), which preserves the *ordering* of
policies (a policy that balances load better drains sooner and shows a
lower measured p99) even though absolute times differ from replicas on
cards of their own.

:func:`measure_replica_times` calibrates a replica's per-prompt-token
prefill and per-step decode seconds from a real warm run, feeding
``ReplicaSpec.from_times`` so the simulator predicts with the measured
constants.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.cost_model import OpticalSystem, transfer_time
from ..runtime.server import BatchedServer, ServerConfig
from .scheduler import Policy, ReplicaView
from .sim import ClusterStats, ReplicaSpec, RequestRecord
from .traces import Request

__all__ = ["ClusterServer", "measure_replica_times"]


def measure_replica_times(cfg, params, scfg: ServerConfig, *,
                          prompt_tokens: int = 8,
                          warmup: int = 1,
                          device: Union[str, torch.device, None] = "cuda",
                          ) -> Tuple[float, float]:
    """Measure (prefill seconds per prompt token, decode seconds per
    engine step) on a throwaway server on ``device`` (where ``params``
    lie): warm runs only, so first-call costs (cuBLAS handles, the
    allocator, kernel loads) don't pollute the constants."""
    srv = BatchedServer(cfg, params, scfg, device=device)
    prompt = np.arange(prompt_tokens, dtype=np.int32) % cfg.vocab_size
    for _ in range(warmup + 1):
        srv.submit(prompt)
        srv.run_until_drained()
    rec = srv.records[max(srv.records)]
    prefill_token_s = (rec.prefill_done_s - rec.prefill_start_s) / prompt_tokens
    if rec.decode_start_s is not None and rec.generated > 1:
        decode_step_s = ((rec.finish_s - rec.decode_start_s)
                         / (rec.generated - 1))
    else:
        decode_step_s = prefill_token_s * prompt_tokens
    return prefill_token_s, decode_step_s


class ClusterServer:
    """Route requests across ``BatchedServer`` replicas via a policy.

    ``servers[i]`` is described by ``specs[i]`` (calibrated via
    :func:`measure_replica_times` + ``ReplicaSpec.from_times`` when the
    simulator should predict this cluster).  All servers must share this
    front end's ``clock`` so cross-replica timestamps are comparable.
    """

    def __init__(self, servers: Sequence[BatchedServer],
                 specs: Sequence[ReplicaSpec], policy: Policy, *,
                 world: str = "electrical",
                 optical: Optional[OpticalSystem] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if len(servers) != len(specs):
            raise ValueError("need one ReplicaSpec per server")
        if world not in ("electrical", "optical"):
            raise ValueError(f"world must be electrical|optical, got {world!r}")
        self.servers = list(servers)
        self.specs = list(specs)
        self.policy = policy
        self.world = world
        self.optical = optical
        self.clock = clock
        self._t0 = clock()
        self._route: Dict[int, Tuple[int, int]] = {}  # gid -> (replica, local rid)
        self._requests: Dict[int, Request] = {}       # gid -> routed Request
        self._next_gid = 0
        self.routed = {s.name: 0 for s in self.specs}
        self.busy_s = {s.name: 0.0 for s in self.specs}

    # -- pricing (same two cost worlds as the simulator) -------------------
    def _tx_time_s(self, spec: ReplicaSpec, nbytes: float) -> float:
        if self.world == "optical":
            from ..core.cost_model import TERARACK
            model = self.optical if self.optical is not None else TERARACK
        else:
            model = spec.link
        return transfer_time(model, nbytes)

    # -- routing snapshot --------------------------------------------------
    def _views(self) -> List[ReplicaView]:
        out = []
        for i, (srv, spec) in enumerate(zip(self.servers, self.specs)):
            backlog = 0.0
            for _, prompt in srv.queue:
                backlog += spec.request_service_s(Request(
                    rid=-1, arrival_s=0.0, prompt_tokens=len(prompt),
                    new_tokens=srv.scfg.max_new_tokens))
            active = srv.active_count()
            if active:
                remaining = max(
                    srv.scfg.max_new_tokens - len(s.generated)
                    for s in srv.slots if s.request_id is not None)
                backlog += max(0, remaining) * spec.decode_step_time_s(active)
            out.append(ReplicaView(
                index=i, spec=spec, queue_len=len(srv.queue), active=active,
                backlog_s=backlog, link_free_in_s=0.0,
                tx_time_s=lambda nb, s=spec: self._tx_time_s(s, nb)))
        return out

    # -- API ---------------------------------------------------------------
    def submit(self, prompt: np.ndarray) -> int:
        return self.submit_batch([prompt])[0]

    def submit_batch(self, prompts: Sequence[np.ndarray]) -> List[int]:
        """Route a batch of simultaneous arrivals jointly (the max-flow
        policy's placement window) and enqueue each on its replica."""
        now = self.clock() - self._t0
        batch = []
        for p in prompts:
            gid = self._next_gid
            self._next_gid += 1
            batch.append(Request(rid=gid, arrival_s=now,
                                 prompt_tokens=len(p), new_tokens=0))
        picks = self.policy.route_batch(batch, self._views(), now)
        gids = []
        for req, p, ridx in zip(batch, prompts, picks):
            srv, spec = self.servers[ridx], self.specs[ridx]
            local = srv.submit(p)
            self._route[req.rid] = (ridx, local)
            self._requests[req.rid] = Request(
                rid=req.rid, arrival_s=req.arrival_s,
                prompt_tokens=req.prompt_tokens,
                new_tokens=srv.scfg.max_new_tokens)
            self.routed[spec.name] += 1
            gids.append(req.rid)
        return gids

    def reset(self) -> None:
        """Reset the whole front end for a fresh trace on the same warm
        replicas: each ``BatchedServer`` drains and clears via its public
        :meth:`~repro_torch.runtime.server.BatchedServer.reset` (weights
        kept), routing state and per-replica counters rebuild, and the
        epoch moves to now: the standard way to re-run a trace under a
        different policy on warm replicas."""
        for srv in self.servers:
            srv.reset()
        self._t0 = self.clock()
        self._route.clear()
        self._requests.clear()
        self._next_gid = 0
        self.routed = {s.name: 0 for s in self.specs}
        self.busy_s = {s.name: 0.0 for s in self.specs}

    def pending_work(self) -> bool:
        return any(s.pending_work() for s in self.servers)

    def engine_step(self):
        """One stepping round: every replica with pending work runs one
        engine step (host-serialized; see the module docstring)."""
        for srv, spec in zip(self.servers, self.specs):
            if srv.pending_work():
                t0 = self.clock()
                srv.engine_step()
                self.busy_s[spec.name] += self.clock() - t0

    def run_trace(self, trace: Sequence["Request"], *,
                  prompts: Optional[Sequence[np.ndarray]] = None,
                  max_steps: int = 100_000) -> ClusterStats:
        """Replay a trace against the live cluster, pacing arrivals on the
        wall clock: submit each request when its ``arrival_s`` elapses
        (same-instant arrivals submit as one routed batch, matching the
        simulator's placement window), stepping the replicas in between.
        Returns the measured :meth:`drain_report`."""
        if prompts is None:
            prompts = [np.arange(r.prompt_tokens, dtype=np.int32)
                       for r in trace]
        t0 = self.clock()
        self._t0 = t0
        i, n, steps = 0, len(trace), 0
        while i < n or self.pending_work():
            now = self.clock() - t0
            if i < n and trace[i].arrival_s <= now:
                j = i + 1
                while j < n and trace[j].arrival_s == trace[i].arrival_s \
                        and trace[j].arrival_s <= now:
                    j += 1
                self.submit_batch(list(prompts[i:j]))
                i = j
                continue
            if self.pending_work():
                self.engine_step()
                steps += 1
                if steps > max_steps:
                    raise RuntimeError("cluster did not drain")
            # idle-wait for the next arrival (spin; traces are short)
        return self.drain_report()

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        steps = 0
        while self.pending_work():
            self.engine_step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("cluster did not drain")
        return self.results()

    def results(self) -> Dict[int, List[int]]:
        out = {}
        for gid, (ridx, local) in self._route.items():
            if local in self.servers[ridx].results:
                out[gid] = self.servers[ridx].results[local]
        return out

    def drain_report(self) -> ClusterStats:
        """Measured :class:`ClusterStats` — same shape as the simulator's,
        timestamps rebased to this front end's epoch."""
        records = []
        for gid in sorted(self._route):
            ridx, local = self._route[gid]
            srv, spec = self.servers[ridx], self.specs[ridx]
            t = srv.records[local]
            req = self._requests[gid]

            def reb(x):
                return None if x is None else x - self._t0

            records.append(RequestRecord(
                rid=gid, replica=spec.name,
                prompt_tokens=t.prompt_tokens, new_tokens=t.generated,
                arrival_s=req.arrival_s, enqueue_s=reb(t.enqueue_s),
                prefill_start_s=reb(t.prefill_start_s),
                prefill_done_s=reb(t.prefill_done_s),
                decode_start_s=reb(t.decode_start_s),
                finish_s=reb(t.finish_s)))
        done = [r for r in records if r.finish_s is not None]
        makespan = (max(r.finish_s for r in done)
                    - min(r.arrival_s for r in done)) if done else 0.0
        return ClusterStats(
            records=records, makespan_s=makespan,
            busy_s=dict(self.busy_s), tx_busy_s={},
            routed=dict(self.routed))
