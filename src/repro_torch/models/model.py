"""Model assembly for the dense, ssm and hybrid families: init / forward /
loss / decode.

The counterpart of ``repro/models/model.py`` for three families:

  dense          : [rmsnorm -> attention -> rmsnorm -> SwiGLU FFN] x L
  ssm (rwkv6)    : [rmsnorm -> time-mix -> rmsnorm -> channel-mix] x L
  hybrid (zamba2): [rmsnorm -> Mamba2] x L, and after every
                   ``hybrid_attn_every``-th layer one shared
                   [rmsnorm -> attention -> rmsnorm -> SwiGLU FFN] block

then the final norm and the (tied or separate) vocabulary head.  The
reference stacks the layers and runs them under ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts and ``forward`` is a
Python loop over it.  The hybrid's shared block has one set of weights
(``params["shared_block"]``) and, in the decode state, one K/V slot per
invocation: layer ``i`` with ``i % every == every - 1`` uses slot
``i // every``.  Other families (moe, vlm, audio) are later slices of the
port.

Parameters are nested dicts of tensors with the reference's names, dtypes
and the JAX layouts (dense ``w`` as ``(d_in, d_out)``), drawn from an
explicit ``torch.Generator`` with the reference's distributions and scales.
The decode state keeps the reference's stacked ``(L, B, ...)`` leaves:
``{"k", "v"}`` caches of ``(L, B, Hkv, T, hd)`` for dense;
``{"rwkv": {"tmix_x": (L, B, d), "cmix_x": (L, B, d), "wkv": (L, B, H, hd,
hd) f32}}`` for ssm; and ``{"mamba": {"conv": (L, B, K-1, d_in + 2N),
"ssm": (L, B, H, P, N) f32}, "shared_k", "shared_v": (L // every, B, Hkv,
T, hd)}`` for hybrid.  Where the reference returns a new state, ``forward``
writes the one it is given in place and returns it: each attention's K/V
at ``cache_pos``, and each layer's recurrent state for every lane, after
that layer has read it.

Training: ``loss_fn`` runs ``forward(..., head_mode="none")`` and the
sequence-chunked cross entropy ``_chunked_xent``.  Where ``cfg.remat`` is
true and grad mode is on, each layer body runs under
``torch.utils.checkpoint`` (its activations are recomputed in the
backward), as the reference's ``_maybe_checkpoint`` wraps its scan body.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import attention, attn_init
from .layers import dense, rmsnorm, rmsnorm_init
from .mamba2 import mamba2_block, mamba2_init, mamba2_state_init
from .mlp import mlp, mlp_init
from .rwkv6 import rwkv6_channel_mix, rwkv6_init, rwkv6_state_init, rwkv6_time_mix

__all__ = ["init_params", "init_decode_state", "forward", "apply_head", "loss_fn",
           "decode_step", "torch_dtype"]

Device = Union[str, torch.device, None]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense, ssm and hybrid families; "
            f"{cfg.family!r} is not ported yet (ROADMAP queue A)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
                     device: torch.device) -> Dict:
    """A dense layer, or the hybrid's shared block: ln1, attn, ln2, ffn."""
    kw = dict(dtype=dtype, device=device)
    return {
        "ln1": rmsnorm_init(cfg.d_model, **kw),
        "attn": attn_init(gen, cfg, **kw),
        "ln2": rmsnorm_init(cfg.d_model, **kw),
        "ffn": mlp_init(gen, cfg, **kw),
    }


def _layer_init(gen: torch.Generator, cfg: ModelConfig, *, dtype: torch.dtype,
                device: torch.device) -> Dict:
    kw = dict(dtype=dtype, device=device)
    if cfg.family == "ssm":  # rwkv6
        p = rwkv6_init(gen, cfg, **kw)
        return {
            "ln1": rmsnorm_init(cfg.d_model, **kw),
            "tmix": p["tmix"],
            "ln2": rmsnorm_init(cfg.d_model, **kw),
            "cmix": p["cmix"],
        }
    if cfg.family == "hybrid":  # zamba2 backbone layer
        return {
            "ln1": rmsnorm_init(cfg.d_model, **kw),
            "mamba": mamba2_init(gen, cfg, **kw),
        }
    return _attn_block_init(gen, cfg, **kw)


def init_params(cfg: ModelConfig, *, seed: int = 0, device: Device = "cuda") -> Dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``.

    The same seed gives the same weights on one device type; the CPU's and
    the card's generators give different numbers (tests that compare
    packages convert the reference's weights with ``from_jax_params``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {}
    # vocab rows are padded to cfg.padded_vocab, as in the reference; the
    # padded logits are dropped after the head
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, device=dev) * 0.02
    params["embed"] = embed.to(dtype)
    params["layers"] = [_layer_init(gen, cfg, dtype=dtype, device=dev)
                        for _ in range(cfg.num_layers)]
    if cfg.hybrid_attn_every:
        params["shared_block"] = _attn_block_init(gen, cfg, dtype=dtype, device=dev)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen, device=dev) * 0.02
        params["lm_head"] = {"w": head.to(dtype)}
    return params


# --------------------------------------------------------------------------
# decode state
# --------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device: Device = "cuda") -> Dict:
    """Zeros in the reference's layout (``max_seq`` is unused for ssm)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    L = cfg.num_layers

    def stacked(one: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((L,) + a.shape, dtype=a.dtype, device=dev) for k, a in one.items()}

    if cfg.family == "ssm":
        return {"rwkv": stacked(rwkv6_state_init(cfg, batch, dtype=dtype, device=dev))}
    if cfg.family == "hybrid":
        kv_shape = (L // cfg.hybrid_attn_every, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
        return {"mamba": stacked(mamba2_state_init(cfg, batch, dtype=dtype, device=dev)),
                "shared_k": torch.zeros(kv_shape, dtype=dtype, device=dev),
                "shared_v": torch.zeros(kv_shape, dtype=dtype, device=dev)}
    shape = (L, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def apply_head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden -> (padded-)vocab logits in f32."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = dense(params["lm_head"], x)
    return logits.float()


def _rwkv_layer_body(cfg: ModelConfig, layer: Dict, x: torch.Tensor,
                     state: Optional[Dict[str, torch.Tensor]]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    st = state or {}
    h, last_t, wkv = rwkv6_time_mix(
        layer["tmix"], cfg, rmsnorm(layer["ln1"], x, cfg.norm_eps),
        last_x=st.get("tmix_x"), wkv_state=st.get("wkv"))
    x = x + h
    h, last_c = rwkv6_channel_mix(
        layer["cmix"], cfg, rmsnorm(layer["ln2"], x, cfg.norm_eps),
        last_x=st.get("cmix_x"))
    return x + h, {"tmix_x": last_t, "cmix_x": last_c, "wkv": wkv}


def _attn_block(cfg: ModelConfig, block: Dict, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]], cache_pos: int) -> torch.Tensor:
    """rmsnorm -> attention -> rmsnorm -> SwiGLU FFN, each with its residual;
    ``kv``, when given, is written in place at ``cache_pos``."""
    h, _ = attention(block["attn"], cfg, rmsnorm(block["ln1"], x, cfg.norm_eps),
                     positions=positions, kv_cache=kv, cache_pos=cache_pos)
    x = x + h
    return x + mlp(block["ffn"], cfg, rmsnorm(block["ln2"], x, cfg.norm_eps))


def _maybe_checkpoint(cfg: ModelConfig, body: Callable) -> Callable:
    """``body`` itself, or ``body`` under ``torch.utils.checkpoint`` where
    ``cfg.remat`` is true and grad mode is on (the reference's
    ``_maybe_checkpoint``: without a gradient, remat changes nothing)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r}: the port has only 'full' "
            f"(ROADMAP queue A, A6)")
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def forward(
    cfg: ModelConfig,
    params: Dict,
    batch: Dict[str, torch.Tensor],
    *,
    cache: Optional[Dict] = None,
    cache_pos: int = 0,
    head_mode: str = "full",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (out, cache).  ``out`` by ``head_mode``: ``"full"`` the
    (B, S, vocab_size) f32 logits, ``"last"`` the (B, vocab_size) logits of
    the last position, ``"none"`` the final-normed (B, S, d) hidden (the
    loss applies the head itself).  ``batch["tokens"]`` is (B, S) on the
    params' device; ``cache``, when given, is written in place (K/V at
    ``cache_pos``; the recurrent state of every lane) and returned."""
    _check_family(cfg)
    if head_mode not in ("full", "last", "none"):
        raise ValueError(f"head_mode {head_mode!r}: 'full', 'last' or 'none'")
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    B, S, _ = x.shape

    if cfg.family == "ssm":
        def body(x, layer, st):
            return _rwkv_layer_body(cfg, layer, x, st)

        body = _maybe_checkpoint(cfg, body)
        for i, layer in enumerate(params["layers"]):
            st = None if cache is None else {k: a[i] for k, a in cache["rwkv"].items()}
            x, new_st = body(x, layer, st)
            if cache is not None:
                for k, a in cache["rwkv"].items():
                    a[i] = new_st[k]
    elif cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        positions = (cache_pos + torch.arange(S, device=x.device)).expand(B, S)

        def body(x, i, layer, st, kv):
            h, new_st = mamba2_block(layer["mamba"], cfg,
                                     rmsnorm(layer["ln1"], x, cfg.norm_eps), state=st)
            x = x + h
            if i % every == every - 1:  # the shared block, with its own K/V slot
                x = _attn_block(cfg, params["shared_block"], x, positions, kv, cache_pos)
            return x, new_st

        body = _maybe_checkpoint(cfg, body)
        for i, layer in enumerate(params["layers"]):
            st = None if cache is None else {k: a[i] for k, a in cache["mamba"].items()}
            kv = None
            if cache is not None and i % every == every - 1:
                kv = (cache["shared_k"][i // every], cache["shared_v"][i // every])
            x, new_st = body(x, i, layer, st, kv)
            if cache is not None:
                for k, a in cache["mamba"].items():
                    a[i] = new_st[k]
    else:
        positions = (cache_pos + torch.arange(S, device=x.device)).expand(B, S)

        def body(x, layer, kv):
            return _attn_block(cfg, layer, x, positions, kv, cache_pos)

        body = _maybe_checkpoint(cfg, body)
        for i, layer in enumerate(params["layers"]):
            kv = None if cache is None else (cache["k"][i], cache["v"][i])
            x = body(x, layer, kv)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if head_mode == "none":
        return x, cache
    if head_mode == "last":
        x = x[:, -1:]
    logits = apply_head(cfg, params, x)[..., :cfg.vocab_size]  # drop vocab padding
    if head_mode == "last":
        logits = logits[:, 0]
    return logits, cache


# --------------------------------------------------------------------------
# training loss
# --------------------------------------------------------------------------
def _chunk_log_likelihood(cfg: ModelConfig, params: Dict, h: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Summed log-likelihood of ``labels`` under the head's logits of one
    (B, chunk, d) slab; the padded vocab columns are masked to -1e30."""
    logits = apply_head(cfg, params, h)  # (B, chunk, Vp) f32
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, labels.long()[..., None]).sum()


def _chunked_xent(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Sequence-chunked cross entropy: the (B, S, V) logits are never all
    live.  The chunk is the largest divisor of S that is at most
    ``cfg.loss_chunk``; each chunk's logits slab is reduced to its summed
    log-likelihood and dropped, and recomputed in the backward."""
    B, S, _ = hidden.shape
    chunk = min(cfg.loss_chunk, S)
    while S % chunk:
        chunk -= 1  # largest divisor <= loss_chunk
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        h, lab = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_log_likelihood, cfg, params, h, lab,
                                       use_reentrant=False)
        else:
            total = total + _chunk_log_likelihood(cfg, params, h, lab)
    return -total / (B * S)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): the mean next-token cross entropy of
    ``batch["labels"]`` given ``batch["tokens"]``, both (B, S)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE loss (load-balance and router-z terms) waits "
            f"for the MoE port (ROADMAP queue A, A7)")
    hidden, _ = forward(cfg, params, batch, head_mode="none")
    ce = _chunked_xent(cfg, params, hidden, batch["labels"])
    return ce, {"ce": ce, "loss": ce}


def decode_step(
    cfg: ModelConfig,
    params: Dict,
    state: Dict,
    tokens: torch.Tensor,  # (B, 1)
    cache_pos: int,
) -> Tuple[torch.Tensor, Dict]:
    """One token of autoregressive decode against the serve state, which is
    written in place for every lane (K/V at ``cache_pos``, and the recurrent
    state advanced by one token)."""
    logits, state = forward(cfg, params, {"tokens": tokens}, cache=state,
                            cache_pos=cache_pos)
    return logits[:, -1], state
