"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, GQA kv=8.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True),
)
