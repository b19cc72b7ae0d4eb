"""Training data of the port (the counterpart of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticLMPipeline  # noqa: F401
