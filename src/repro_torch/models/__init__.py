"""Dense, rwkv6 and zamba2 decoders of the port (the counterpart of ``repro.models``)."""
from .convert import from_jax_params  # noqa: F401
from .model import (  # noqa: F401
    apply_head,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
)
