"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

The same names and configurations as ``repro.configs``, and the same input
shapes (``SHAPES``, ``shape_supported``, ``input_specs``).  The port runs
every family: dense, moe, ssm (rwkv6), hybrid (zamba2), vlm (phi-3-vision,
served on tokens alone) and audio (hubert, an encoder: no decode).
"""
from typing import Dict, List

from .base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    TensorSpec,
    active_param_count,
    expert_parallel,
    input_specs,
    param_count,
    reduced,
    shape_supported,
)

from . import (
    arctic_480b,
    granite_3_2b,
    hubert_xlarge,
    llama4_scout_17b_a16e,
    phi4_mini_3_8b,
    phi_3_vision_4_2b,
    qwen2_5_32b,
    qwen3_32b,
    rwkv6_7b,
    zamba2_2_7b,
)

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_5_32b,
        qwen3_32b,
        phi4_mini_3_8b,
        granite_3_2b,
        rwkv6_7b,
        llama4_scout_17b_a16e,
        arctic_480b,
        zamba2_2_7b,
        phi_3_vision_4_2b,
        hubert_xlarge,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)
