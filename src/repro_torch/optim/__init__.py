"""Optimizer of the port (the counterpart of ``repro.optim``).

``zero1`` holds the explicit ZeRO-1 gradient sharding over a data-parallel
world, which ``runtime.make_dp_train_step`` runs every step; the sharding
specs (``opt_state_specs``) come with the DTensor placements (ROADMAP
A12c)."""
from .adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
)
from .zero1 import (  # noqa: F401
    zero1_shard_grads,
    zero1_unshard_params,
)
