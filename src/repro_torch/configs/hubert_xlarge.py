"""hubert-xlarge [audio] — encoder-only transformer (w2v2 arch).
[arXiv:2106.07447; unverified]

The conv feature extractor is a stub: the model takes precomputed frame
embeddings (B, S, d_model) as ``batch["embeds"]``.  Encoder-only =>
bidirectional attention, no decode shapes.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend="audio",
)
