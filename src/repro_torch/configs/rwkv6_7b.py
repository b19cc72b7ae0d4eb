"""rwkv6-7b (Finch) [ssm] — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # rwkv6 head count = d_model / head_size(64)
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
)
