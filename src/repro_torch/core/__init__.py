"""OpTree core: m-ary tree all-gather scheduling (paper §III) + mesh planner.

A copy of ``repro/core`` (numpy and the standard library only), so the
port imports nothing of the reference; ``tests/test_torch_core.py`` holds
every exported name equal to the original on the same inputs.
"""
from .tree import (  # noqa: F401
    OpTreePlan,
    balanced_factors,
    optimal_depth_argmin,
    optimal_depth_thm2,
)
from .steps import (  # noqa: F401
    lemma1_wavelengths_line,
    lemma1_wavelengths_ring,
    neighbor_exchange_steps,
    one_stage_steps,
    optree_optimal_steps,
    optree_steps_exact,
    optree_steps_thm1,
    ring_steps,
    table1,
    wrht_steps_formula,
    wrht_steps_paper_table,
)
from .schedule import (  # noqa: F401
    Schedule,
    Tx,
    build_ne_schedule,
    build_one_stage_schedule,
    build_optree_schedule,
    build_ring_schedule,
    schedule_from_ir,
)
from .validate import validate_health, validate_schedule  # noqa: F401
from .health import (  # noqa: F401
    DeadAxisError,
    DeadDirectionError,
    FaultEvent,
    FaultTrace,
    HealthError,
    LinkHealth,
    health_fingerprint,
    load_health,
)
from .cost_model import (  # noqa: F401
    TERARACK,
    CircuitReconfig,
    OpticalSystem,
    PriceReport,
    allgather_time,
    derive_wavelengths,
    eq3_time,
    price,
    step_time,
    transfer_time,
)
from .plan_ir import (  # noqa: F401
    COLLECTIVES,
    CollectiveKind,
    CollectivePlan,
    Hop,
    PlanStage,
    Transfer,
    collective_kind,
    expand_hops,
    optical_message_bytes,
)
from .planner import (  # noqa: F401
    DCN_LINK,
    ICI_LINK,
    AllGatherPlan,
    HopSchedule,
    LinkSpec,
    OrderCandidate,
    OrderSearch,
    choose_hop_schedule,
    load_links,
    plan_axis_order,
    plan_staged_allgather,
    search_stage_orders,
)
