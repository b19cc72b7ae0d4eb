"""Staged collectives on ``torch.distributed``: the OpTree technique over a
world of processes, one rank per device.

A copy of ``repro.comms`` translated from ``shard_map`` programs to
per-rank code: every op takes this rank's local shard, a
:class:`FactorizedMesh` stands for the reference's factorized device mesh
(one process group per axis tuple), ``lax.ppermute`` becomes
``batch_isend_irecv`` and the tiled ``lax`` collectives the flat
``torch.distributed`` ones.  User-facing surface: ``comm_context`` + the
``api`` module ops (one context-scoped entry point over the
CollectivePlan IR); everything else is internals or deprecation shims.
The fused collective-matmul ops (``allgather_matmul``,
``matmul_reduce_scatter``, whose rings live in
``collective_matmul.py``) and ``sharded_decode_attention`` are
ROADMAP A6.  The fault layer (A10) is ``execute_plan_verified``
(conservation checksums per stage, bounded retry, the one-shot fallback;
``PlanPolicy(verify=True)`` routes every op through it) and its chaos
hook, ``fault_injection(FaultInjection(...))``.
"""
from .mesh_utils import FactorizedMesh, init_world, make_factorized_mesh  # noqa: F401
from .staged_allgather import (  # noqa: F401
    staged_all_gather,
    optree_all_gather,
    canonical_all_gather,
)
from .staged_collectives import (  # noqa: F401
    StagedCollectiveEngine,
    plan_collectives,
    staged_all_gather_chunked,
    staged_all_reduce,
    staged_all_to_all,
    staged_reduce_scatter,
    tp_all_reduce,
)
from .ring_executor import (  # noqa: F401
    FaultInjection,
    fault_injection,
    hybrid_all_gather,
    hybrid_all_reduce,
    hybrid_all_to_all,
    hybrid_reduce_scatter,
    perhop_all_gather,
    perhop_all_reduce,
    perhop_all_to_all,
    perhop_reduce_scatter,
    ring_all_gather_stage,
    ring_all_to_all_stage,
    ring_reduce_scatter_stage,
)
from .plan_executor import execute_plan, execute_plan_verified  # noqa: F401
from . import api  # noqa: F401
from .api import (  # noqa: F401
    CommContext,
    PlanPolicy,
    allgather_matmul,
    comm_context,
    current_context,
    matmul_reduce_scatter,
)
from .collectives import (  # noqa: F401
    ring_all_gather,
    neighbor_exchange_all_gather,
    one_stage_all_gather,
    hierarchical_all_reduce,
    reduce_scatter,
)
from .decode_attention import sharded_decode_attention  # noqa: F401
