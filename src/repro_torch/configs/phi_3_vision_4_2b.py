"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The modality frontend is a stub: precomputed patch embeddings are merged
into the first ``num_prefix_embeds`` positions of the token stream
(``batch["image_embeds"]``; the server passes tokens alone).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    frontend="vision",
    num_prefix_embeds=576,  # one CLIP-ViT-L/14 336px tile
)
