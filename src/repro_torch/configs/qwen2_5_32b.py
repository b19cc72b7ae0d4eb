"""qwen2.5-32b [dense] — GQA (kv=8), QKV bias, RoPE, SwiGLU.
[hf:Qwen/Qwen2.5-0.5B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)
