"""Optimizer of the port (the counterpart of ``repro.optim``).

The sharding specs (``opt_state_specs``) and ZeRO-1 (``optim/zero1.py``)
wait for the collectives port (ROADMAP queue A, A5b and A6)."""
from .adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
)
