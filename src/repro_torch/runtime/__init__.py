"""Serving runtime of the port (the counterpart of ``repro.runtime``)."""
from .server import BatchedServer, RequestTiming, ServerConfig  # noqa: F401
