"""Serving and training runtimes of the port (the counterpart of ``repro.runtime``)."""
from .server import BatchedServer, RequestTiming, ServerConfig  # noqa: F401
from .trainer import (  # noqa: F401
    Trainer,
    TrainerConfig,
    make_dp_train_step,
    make_train_step,
    replan,
)
