"""Serving phase-time queries on the two-term roofline, for one H100.

The phase helpers of ``repro/launch/roofline.py`` that the cluster
simulator prices replicas with (``cluster.sim.ReplicaSpec.from_config``):
a prefill or a decode step takes the larger of its compute time (2 FLOPs
per active parameter and token against ``PEAK_FLOPS``) and one streaming
pass over the weights against ``HBM_BW``.

The hardware model is the NVIDIA H100 SXM's data sheet, not a
measurement: 989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of
HBM3, the figures ``chip_smoke.py`` computes its kernels' bounds with.
The reference's dry-run roofline analysis (XLA cost analysis of sharded
programs) is not here.
"""
from __future__ import annotations

from ..configs import active_param_count, param_count

__all__ = ["PEAK_FLOPS", "HBM_BW", "prefill_time_s", "decode_step_time_s"]

PEAK_FLOPS = 989e12  # H100 SXM spec sheet: dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # H100 SXM spec sheet: HBM3 bytes/s

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _weight_bytes(cfg) -> float:
    return float(param_count(cfg)) * _DTYPE_BYTES.get(cfg.dtype, 2)


def prefill_time_s(cfg, prompt_tokens: int, *, chips: int = 1,
                   peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW) -> float:
    """Roofline prefill time for one request of ``prompt_tokens``.

    ``max(compute, memory)``: 2·N_active FLOPs per token against the
    tensor-core peak, against one streaming pass over the weights; the
    request phases the cluster simulator prices (``cluster.sim``).
    """
    flops = 2.0 * active_param_count(cfg) * prompt_tokens / chips
    return max(flops / peak_flops, _weight_bytes(cfg) / chips / hbm_bw)


def decode_step_time_s(cfg, batch: int = 1, *, chips: int = 1,
                       peak_flops: float = PEAK_FLOPS,
                       hbm_bw: float = HBM_BW) -> float:
    """Roofline time of ONE decode engine step over ``batch`` active slots.

    Decode streams the full weight set for a handful of tokens, so the HBM
    term dominates until the batch is hundreds wide: the memory-bound
    regime the continuous-batching slot pool exists to amortize.
    """
    flops = 2.0 * active_param_count(cfg) * batch / chips
    return max(flops / peak_flops, _weight_bytes(cfg) / chips / hbm_bw)
