"""phi4-mini-3.8b [dense] — RoPE, SwiGLU, GQA (kv=8). [arXiv:2412.08905; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    rope_theta=1e4,
)
