"""Optical WDM ring interconnect simulator (TeraRack-style, paper §IV).

A copy of ``repro/optics``, held equal to it by ``tests/test_torch_core.py``.
"""
from .simulator import SimReport, simulate  # noqa: F401
from .comparison import compare_algorithms  # noqa: F401
