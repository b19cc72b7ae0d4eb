"""Serving and training runtimes of the port (the counterpart of ``repro.runtime``)."""
from .server import BatchedServer, RequestTiming, ServerConfig  # noqa: F401
from .trainer import Trainer, TrainerConfig, make_train_step, replan  # noqa: F401
