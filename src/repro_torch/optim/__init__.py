"""Optimizer of the port (the counterpart of ``repro.optim``).

``zero1`` holds the explicit ZeRO-1 gradient sharding over a data-parallel
world, which ``runtime.make_dp_train_step`` runs every step;
``opt_state_specs`` is the ZeRO-1 of sharding specs, which the spec path
(``runtime.make_spec_train_step``) places as DTensors."""
from .adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    opt_state_specs,
)
from .zero1 import (  # noqa: F401
    zero1_shard_grads,
    zero1_unshard_params,
)
