"""Mesh axis roles of the port (the counterpart of ``repro/models/sharding.py``).

Only ``dp_axes`` so far: the data-parallel axes over which the explicit
ZeRO-1 step (``runtime.trainer.make_dp_train_step``) splits the batch.
The reference's GSPMD placements (``param_specs``, ``batch_specs`` and the
rest) map to DTensor placements in ROADMAP A12c.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["dp_axes"]


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (anything with a ``shape``
    mapping of axis names), major first: ``pod`` then ``data``."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
