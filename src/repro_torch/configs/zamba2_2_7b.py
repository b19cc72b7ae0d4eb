"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

The shared attention block (one weight set, reused) runs every 6th layer;
the per-invocation LoRA deltas of the released model are omitted.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    hybrid_attn_every=6,
    # scan_chunk: time-chunked remat of the SSD recurrence (train-time
    # activation memory /16)
    ssm=SSMConfig(kind="mamba2", head_dim=64, state_dim=64, expand=2,
                  scan_chunk=128),
)
