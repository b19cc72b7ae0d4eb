"""Routing policies for the cluster serving layer.

A copy of ``repro/cluster/scheduler.py`` (pure Python), held equal to it
by ``tests/test_torch_cluster.py``.

Every policy sees the same :class:`ReplicaView` snapshot per decision —
queue depth, active slots, the replica's committed backlog in seconds,
link availability, and a transmission pricer closed over the run's cost
world (electrical ``LinkSpec`` or optical Eq. 3) — and returns replica
indices.  Four families, in increasing use of the cost model:

* :class:`RoundRobin` — arrival-order striping; the cost-blind baseline
  every benchmark compares against;
* :class:`JoinShortestQueue` — classic JSQ on in-flight request count;
* :class:`GreedyCost` — picks the replica minimizing the request's
  estimated finish time (link wait + tx + backlog + solo service), i.e.
  the same α–β / Eq.-3 + roofline arithmetic the collective planner uses;
* :class:`MaxFlowPolicy` — Helix-style joint placement for simultaneous
  arrival batches: a max-flow round over a request→replica bipartite
  graph capacitated by free slots routes as many requests as possible to
  non-overfull replicas at once, then a greedy-cost pass places the
  overflow.

Policies are pure given their inputs (ties broken by replica index), so
a seeded trace routes identically run-to-run — the determinism contract
of ``cluster.sim``.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from .sim import BYTES_PER_TOKEN, ReplicaSpec
from .traces import Request

__all__ = ["ReplicaView", "Policy", "RoundRobin", "JoinShortestQueue",
           "GreedyCost", "MaxFlowPolicy", "POLICIES", "make_policy"]


@dataclass(frozen=True)
class ReplicaView:
    """Point-in-time snapshot of one replica, as a policy sees it."""

    index: int
    spec: ReplicaSpec
    queue_len: int          # requests queued, not yet in a slot
    active: int             # occupied decode slots
    backlog_s: float        # committed seconds of work ahead of a new arrival
    link_free_in_s: float   # seconds until the ingress link is free
    tx_time_s: Callable[[float], float]  # nbytes -> seconds, cost-world priced

    @property
    def in_flight(self) -> int:
        return self.queue_len + self.active

    @property
    def free_slots(self) -> int:
        return max(0, self.spec.batch_size - self.active)

    def est_finish_s(self, req: Request) -> float:
        """Estimated completion delay for routing ``req`` here now: wait
        for the link, transmit the prompt, wait out the backlog, then the
        request's solo service time."""
        tx = self.tx_time_s(req.prompt_tokens * BYTES_PER_TOKEN)
        return (self.link_free_in_s + tx + self.backlog_s
                + self.spec.request_service_s(req))


class Policy:
    """Base: implement :meth:`route`; :meth:`route_batch` defaults to
    independent per-request routing against the same snapshot."""

    name = "policy"

    def route(self, req: Request, views: Sequence[ReplicaView],
              now: float) -> int:
        raise NotImplementedError

    def route_batch(self, batch: Sequence[Request],
                    views: Sequence[ReplicaView], now: float) -> List[int]:
        return [self.route(r, views, now) for r in batch]


class RoundRobin(Policy):
    name = "round-robin"

    def __init__(self):
        self._next = 0

    def route(self, req: Request, views: Sequence[ReplicaView],
              now: float) -> int:
        pick = self._next % len(views)
        self._next += 1
        return pick


class JoinShortestQueue(Policy):
    name = "jsq"

    def route(self, req: Request, views: Sequence[ReplicaView],
              now: float) -> int:
        return min(views, key=lambda v: (v.in_flight, v.index)).index

    def route_batch(self, batch: Sequence[Request],
                    views: Sequence[ReplicaView], now: float) -> List[int]:
        # account for our own picks within the batch, else a burst of k
        # simultaneous arrivals all join the momentarily-shortest queue
        load = {v.index: v.in_flight for v in views}
        out = []
        for _ in batch:
            pick = min(views, key=lambda v: (load[v.index], v.index)).index
            load[pick] += 1
            out.append(pick)
        return out


class GreedyCost(Policy):
    name = "greedy"

    def route(self, req: Request, views: Sequence[ReplicaView],
              now: float) -> int:
        return min(views, key=lambda v: (v.est_finish_s(req), v.index)).index

    def route_batch(self, batch: Sequence[Request],
                    views: Sequence[ReplicaView], now: float) -> List[int]:
        # fold each pick's service into a running backlog estimate so a
        # simultaneous burst spreads by cost instead of piling onto the
        # single momentarily-cheapest replica
        extra = collections.defaultdict(float)
        out = []
        for req in batch:
            pick = min(views, key=lambda v: (
                v.est_finish_s(req) + extra[v.index], v.index))
            extra[pick.index] += pick.spec.request_service_s(req)
            out.append(pick.index)
        return out


def _max_flow(capacity: Dict[int, Dict[int, int]], src: int,
              sink: int) -> Dict[int, Dict[int, int]]:
    """Edmonds–Karp on an integer-capacity adjacency dict; returns the
    flow assignment.  Graphs here are tiny (requests + replicas + 2
    nodes), so BFS augmentation is plenty."""
    flow: Dict[int, Dict[int, int]] = collections.defaultdict(
        lambda: collections.defaultdict(int))

    while True:
        # BFS for an augmenting path in the residual graph
        parent = {src: None}
        frontier = collections.deque([src])
        while frontier and sink not in parent:
            u = frontier.popleft()
            nbrs = set(capacity.get(u, {})) | {w for w in flow if flow[w][u] > 0}
            for v in sorted(nbrs):
                if v in parent:
                    continue
                if capacity.get(u, {}).get(v, 0) - flow[u][v] > 0 \
                        or flow[v][u] > 0:
                    parent[v] = u
                    frontier.append(v)
        if sink not in parent:
            return flow
        # bottleneck along the path
        path, v = [], sink
        while parent[v] is not None:
            u = parent[v]
            path.append((u, v))
            v = u
        bott = min(
            (capacity.get(u, {}).get(v, 0) - flow[u][v]) + flow[v][u]
            for u, v in path)
        for u, v in path:
            fwd = capacity.get(u, {}).get(v, 0) - flow[u][v]
            use = min(bott, fwd)
            flow[u][v] += use
            if bott > use:           # rest cancels reverse flow
                flow[v][u] -= bott - use


class MaxFlowPolicy(Policy):
    """Joint placement for simultaneous arrivals via max flow.

    Build source→request (cap 1) →replica (cap 1 per edge, cheapest-first
    edge order) →sink (cap = free slots); the max-flow round admits as
    many requests as slot capacity allows without overfilling any
    replica, and a greedy-cost pass places whatever the flow could not
    (batch larger than total free slots).  Singleton arrivals reduce to
    greedy-cost — the flow formulation only bites on bursts.
    """

    name = "max-flow"

    def __init__(self):
        self._greedy = GreedyCost()

    def route(self, req: Request, views: Sequence[ReplicaView],
              now: float) -> int:
        return self._greedy.route(req, views, now)

    def route_batch(self, batch: Sequence[Request],
                    views: Sequence[ReplicaView], now: float) -> List[int]:
        if len(batch) <= 1:
            return self._greedy.route_batch(batch, views, now)
        R, V = len(batch), len(views)
        SRC, SINK = R + V, R + V + 1
        cap: Dict[int, Dict[int, int]] = {SRC: {}, SINK: {}}
        for i in range(R):
            cap[SRC][i] = 1
            cap[i] = {R + v.index: 1 for v in views}
        for v in views:
            cap[R + v.index] = {SINK: v.free_slots}
        flow = _max_flow(cap, SRC, SINK)
        picks: List[Optional[int]] = [None] * R
        for i in range(R):
            for v in views:
                if flow[i][R + v.index] > 0:
                    picks[i] = v.index
                    break
        # flow says WHERE capacity exists, not which pairing is cheapest:
        # reassign admitted requests to their flow-selected replica set
        # cheapest-first, then greedy-place the unadmitted overflow
        admitted = [i for i in range(R) if picks[i] is not None]
        slots = collections.Counter(picks[i] for i in admitted)
        by_view = {v.index: v for v in views}
        for i in admitted:
            req = batch[i]
            best = min((r for r in slots if slots[r] > 0),
                       key=lambda r: (by_view[r].est_finish_s(req), r))
            picks[i] = best
            slots[best] -= 1
        extra = collections.defaultdict(float)
        for i in range(R):
            if picks[i] is None:
                req = batch[i]
                pick = min(views, key=lambda v: (
                    v.est_finish_s(req) + extra[v.index], v.index))
                extra[pick.index] += pick.spec.request_service_s(req)
                picks[i] = pick.index
        return [int(p) for p in picks]


POLICIES = {
    "round-robin": RoundRobin,
    "jsq": JoinShortestQueue,
    "greedy": GreedyCost,
    "max-flow": MaxFlowPolicy,
}


def make_policy(name: str) -> Policy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; choose from {sorted(POLICIES)}")
