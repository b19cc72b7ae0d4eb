"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    rope_theta=1e4,
    moe=MoEConfig(
        num_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True
    ),
)
