"""Checkpoints of the port (the counterpart of ``repro.checkpoint``)."""
from .checkpointer import Checkpointer  # noqa: F401
