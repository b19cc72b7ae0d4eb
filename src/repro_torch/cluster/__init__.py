"""Cluster-scale serving: seeded traces, an event-driven simulator, and a
multi-replica front end sharing one routing-policy and cost-model stack.

The port of ``repro.cluster``:

* :mod:`repro_torch.cluster.traces`: seeded Poisson/bursty/replay arrival
  traces;
* :mod:`repro_torch.cluster.sim`: event-driven simulator pricing
  transmission with the electrical/optical cost backends and compute with
  the roofline phase model (H100 spec-sheet peaks, ``launch.roofline``);
* :mod:`repro_torch.cluster.scheduler`: round-robin / JSQ / greedy-cost /
  max-flow routing policies over :class:`ReplicaView` snapshots;
* :mod:`repro_torch.cluster.frontend`: :class:`ClusterServer` wrapping N
  real ``BatchedServer`` replicas behind the same policies, emitting the
  same :class:`ClusterStats` for simulated-vs-measured validation.
"""
from .frontend import ClusterServer, measure_replica_times
from .scheduler import (GreedyCost, JoinShortestQueue, MaxFlowPolicy,
                        POLICIES, Policy, ReplicaView, RoundRobin,
                        make_policy)
from .sim import (BYTES_PER_TOKEN, ClusterSim, ClusterStats, ReplicaSpec,
                  RequestRecord)
from .traces import (Request, bursty_trace, make_trace, poisson_trace,
                     replay_trace, save_trace, trace_to_json)

__all__ = [
    "Request", "poisson_trace", "bursty_trace", "replay_trace",
    "trace_to_json", "save_trace", "make_trace",
    "ReplicaSpec", "RequestRecord", "ClusterStats", "ClusterSim",
    "BYTES_PER_TOKEN",
    "ReplicaView", "Policy", "RoundRobin", "JoinShortestQueue",
    "GreedyCost", "MaxFlowPolicy", "POLICIES", "make_policy",
    "ClusterServer", "measure_replica_times",
]
