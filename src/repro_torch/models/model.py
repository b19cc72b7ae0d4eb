"""Model assembly for every family: init / forward / loss / decode.

The counterpart of ``repro/models/model.py``:

  dense, vlm     : [rmsnorm -> attention -> rmsnorm -> SwiGLU FFN] x L
  audio          : [rmsnorm -> attention -> rmsnorm -> GELU FFN] x L,
                   bidirectional (an encoder)
  moe            : [rmsnorm -> attention -> rmsnorm -> MoE block] x L
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
``i // every``.  The MoE block (``models/moe.py``) returns auxiliary
losses, summed over the layers as the reference's scan carry sums them.
The inputs enter through ``_embed_inputs``: token ids through the
embedding table; an audio model's precomputed frame embeddings
``batch["embeds"]`` in their place (it has no table); a vision model's
``batch["image_embeds"]`` written over the first positions of its token
embeddings.

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

Parameters and inputs may be DTensors (``launch.train --zero1 spec``): the
same code then runs in global semantics, DTensor's sharding propagation
placing every intermediate, and ``sharding.constrain`` redistributes the
hidden state where the reference constrains it (after the embedding, after
each layer, after the final norm) and the logits on the head.  On plain
tensors ``constrain`` returns its input.

Training: ``loss_fn`` runs the layers with ``head_mode="none"`` and the
sequence-chunked cross entropy ``_chunked_xent``, plus, for an MoE model,
the reference's load-balance and router-z terms.  Where ``cfg.remat`` is
true and grad mode is on, each layer body runs under
``torch.utils.checkpoint`` (its activations are recomputed in the
backward), as the reference's ``_maybe_checkpoint`` wraps its scan body:
``remat_policy="full"`` recomputes everything, ``"dots"`` saves the
outputs of the matrix products without a batch dimension.

The explicit tensor-parallel block (``transformer_block_tp``, with
``tp_block_specs`` and ``convert.shard_tp_layer`` to cut a full layer into
this rank's slice) runs one process per rank on the collectives of
``repro_torch.comms``; ``transformer_block_ref`` is the same block on the
full layer.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels.local import call_local
from ..tree import is_dtensor
from .attention import (
    attention,
    attention_heads,
    attention_tp_out,
    attention_tp_out_sp,
    attn_init,
)
from .layers import dense, rmsnorm, rmsnorm_init
from .mamba2 import mamba2_block, mamba2_init, mamba2_state_init
from .mlp import ffn_apply_tp, ffn_apply_tp_sp, mlp, mlp_init
from .moe import moe_block, moe_init
from .rwkv6 import rwkv6_channel_mix, rwkv6_init, rwkv6_state_init, rwkv6_time_mix
from .sharding import constrain, whole_sequence

__all__ = ["init_params", "init_decode_state", "forward", "apply_head", "loss_fn",
           "decode_step", "torch_dtype", "transformer_block_tp", "transformer_block_ref",
           "tp_block_specs"]

Device = Union[str, torch.device, None]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}, not one of {_FAMILIES}")


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
    if cfg.moe is not None:
        return {
            "ln1": rmsnorm_init(cfg.d_model, **kw),
            "attn": attn_init(gen, cfg, **kw),
            "ln2": rmsnorm_init(cfg.d_model, **kw),
            "moe": moe_init(gen, cfg, **kw),
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
    if cfg.frontend != "audio":  # an audio model takes frame embeddings: no table
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
def _rows_rule(tokens, table):
    """``_embedding_rows``' placements: the tokens keep their batch split,
    the table is whole on every rank, and its gradient is a partial sum
    over the mesh dims that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in tokens.placements]
    whole = [Replicate()] * len(pl)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    return [pl, whole], [pl, grad], [pl]


def _embedding_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a DTensor table: indexing runs on each rank's
    rows of the batch against the whole table (``kernels.local.call_local``),
    the op the one-device path runs, so one rank computes its bits.  DTensor
    has no rule for indexing's backward in torch 2.11, and its
    ``F.embedding`` rule sums the table's gradient in another order."""
    B, S = tokens.shape
    return call_local(lambda t, w: w[t.long()], _rows_rule, (tokens, table),
                      ((B, S, table.shape[1]),), "embedding")


def _embed_inputs(cfg: ModelConfig, params: Dict, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """The (B, S, d) input of the first layer, in the model's dtype.  Audio:
    ``batch["embeds"]``.  Otherwise the embedding rows of ``batch["tokens"]``,
    and for a vision model with ``batch["image_embeds"]`` (B, P, d) those
    written over positions [0, P), as the reference's
    ``dynamic_update_slice`` at (0, 0, 0) writes them; an image block larger
    than the token embeddings in any dimension raises, as it does there.
    A DTensor table is read on each rank's rows (``_embedding_rows``)."""
    if cfg.frontend == "audio":
        return batch["embeds"].to(torch_dtype(cfg))
    if is_dtensor(params["embed"]):
        x = _embedding_rows(params["embed"], batch["tokens"])
    else:
        x = params["embed"][batch["tokens"].long()]
    if cfg.frontend == "vision" and "image_embeds" in batch:
        img = batch["image_embeds"]
        if img.dim() != 3 or any(a > b for a, b in zip(img.shape, x.shape)):
            raise ValueError(f"image_embeds {tuple(img.shape)} do not fit in the token "
                             f"embeddings {tuple(x.shape)}")
        x[:img.shape[0], :img.shape[1], :img.shape[2]] = img.to(x.dtype)
    return x


def apply_head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden -> (padded-)vocab logits in f32."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = dense(params["lm_head"], x)
    return logits.float()


def _mixer_input(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """The normed input of a token mixer or FFN: the norm runs where the
    residual stream is (sequence shards between layers under sequence
    parallelism), its output is whole along the sequence
    (``sharding.whole_sequence``; plain tensors pass through).  Inside a
    layer the residual stream is whole too (``whole_sequence(x) + h``), so
    no gradient of a projection arrives split over the sequence, which
    the backward of a (B, S) -> rows flatten refuses."""
    return whole_sequence(rmsnorm(p, x, eps))


def _rwkv_layer_body(cfg: ModelConfig, layer: Dict, x: torch.Tensor,
                     state: Optional[Dict[str, torch.Tensor]]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    st = state or {}
    h, last_t, wkv = rwkv6_time_mix(
        layer["tmix"], cfg, _mixer_input(layer["ln1"], x, cfg.norm_eps),
        last_x=st.get("tmix_x"), wkv_state=st.get("wkv"))
    x = whole_sequence(x) + h
    h, last_c = rwkv6_channel_mix(
        layer["cmix"], cfg, _mixer_input(layer["ln2"], x, cfg.norm_eps),
        last_x=st.get("cmix_x"))
    return constrain(x + h, "hidden"), {"tmix_x": last_t, "cmix_x": last_c, "wkv": wkv}


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    return {"load_balance": torch.zeros((), dtype=torch.float32, device=device),
            "router_z": torch.zeros((), dtype=torch.float32, device=device)}


def _attn_block(cfg: ModelConfig, block: Dict, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]], cache_pos: int
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """rmsnorm -> attention -> rmsnorm -> SwiGLU FFN or MoE block, each with
    its residual; ``kv``, when given, is written in place at ``cache_pos``.
    Returns (x, the MoE block's aux losses, or None without one)."""
    h, _ = attention(block["attn"], cfg, _mixer_input(block["ln1"], x, cfg.norm_eps),
                     positions=positions, kv_cache=kv, cache_pos=cache_pos)
    x = whole_sequence(x) + h
    if "moe" in block:
        h, aux = moe_block(block["moe"], cfg, _mixer_input(block["ln2"], x, cfg.norm_eps))
        return constrain(x + h, "hidden"), aux
    h = mlp(block["ffn"], cfg, _mixer_input(block["ln2"], x, cfg.norm_eps))
    return constrain(x + h, "hidden"), None


#: the matrix products without a batch dimension: the operators whose
#: outputs ``remat_policy="dots"`` saves (``bmm`` and ``einsum``'s batched
#: products are recomputed, as ``checkpoint_dots_with_no_batch_dims``
#: recomputes a ``dot_general`` with batch dimensions)
_DOTS_SAVED = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_checkpoint(cfg: ModelConfig, body: Callable) -> Callable:
    """``body`` itself, or ``body`` under ``torch.utils.checkpoint`` where
    ``cfg.remat`` is true and grad mode is on (the reference's
    ``_maybe_checkpoint``: without a gradient, remat changes nothing).
    ``remat_policy="dots"`` keeps the products of ``_DOTS_SAVED`` and
    recomputes the rest, the port's counterpart of the reference's
    ``checkpoint_dots_with_no_batch_dims``; ``"full"`` recomputes
    everything.  Any other policy raises (the reference would silently
    treat it as ``"full"``)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: expected 'full' or 'dots'")
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *args: checkpoint(body, *args, use_reentrant=False,
                                        context_fn=context_fn)
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
    loss applies the head itself).  ``batch`` holds ``"tokens"`` (B, S), or
    for an audio model ``"embeds"`` (B, S, d), and for a vision model
    optionally ``"image_embeds"`` (B, P, d), all on the params' device;
    ``cache``, when given, is written in place (K/V at ``cache_pos``; the
    recurrent state of every lane) and returned."""
    out, cache, _ = _forward(cfg, params, batch, cache=cache, cache_pos=cache_pos,
                             head_mode=head_mode)
    return out, cache


def _forward(
    cfg: ModelConfig,
    params: Dict,
    batch: Dict[str, torch.Tensor],
    *,
    cache: Optional[Dict] = None,
    cache_pos: int = 0,
    head_mode: str = "full",
) -> Tuple[torch.Tensor, Optional[Dict], Optional[Dict[str, torch.Tensor]]]:
    """``forward``, and the MoE aux losses summed over the layers, as the
    reference's ``forward`` returns them (None for a family without MoE,
    whose aux only ``loss_fn`` would read, and does not)."""
    _check_family(cfg)
    if head_mode not in ("full", "last", "none"):
        raise ValueError(f"head_mode {head_mode!r}: 'full', 'last' or 'none'")
    x = constrain(_embed_inputs(cfg, params, batch), "hidden")
    B, S, _ = x.shape
    aux = _zero_aux(x.device) if cfg.moe is not None else None

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
                                     _mixer_input(layer["ln1"], x, cfg.norm_eps), state=st)
            x = whole_sequence(x) + h
            if i % every == every - 1:  # the shared block, with its own K/V slot
                x, _ = _attn_block(cfg, params["shared_block"], x, positions, kv, cache_pos)
            return constrain(x, "hidden"), new_st

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
            x, layer_aux = body(x, layer, kv)
            if layer_aux is not None:
                aux = {k: a + layer_aux[k] for k, a in aux.items()}

    x = constrain(rmsnorm(params["final_norm"], x, cfg.norm_eps), "hidden")
    if head_mode == "none":
        return x, cache, aux
    x = whole_sequence(x)
    if head_mode == "last":
        x = x[:, -1:]
    logits = constrain(apply_head(cfg, params, x), "logits")
    logits = logits[..., :cfg.vocab_size]  # drop vocab padding
    if head_mode == "last":
        logits = logits[:, 0]
    return logits, cache, aux


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
    hidden = whole_sequence(hidden)
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
    ``batch["labels"]`` (B, S) given the inputs of ``forward`` (``tokens``,
    or an audio model's ``embeds``; a vision model's ``image_embeds``); for an MoE
    model plus ``0.01 * load_balance + router_z_loss * router_z``, each
    the per-layer mean, both reported."""
    hidden, _, aux = _forward(cfg, params, batch, head_mode="none")
    ce = _chunked_xent(cfg, params, hidden, batch["labels"])
    total = ce
    metrics = {"ce": ce}
    if cfg.moe is not None:
        lb = aux["load_balance"] / cfg.num_layers
        rz = aux["router_z"] / cfg.num_layers
        total = total + 0.01 * lb + cfg.moe.router_z_loss * rz
        metrics.update(load_balance=lb, router_z=rz)
    metrics["loss"] = total
    return total, metrics


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


# --------------------------------------------------------------------------
# explicit-TP transformer block (context collectives)
# --------------------------------------------------------------------------

_TP_COL = frozenset({"wq", "wk", "wv", "gate", "up"})   # column-parallel
_TP_ROW = frozenset({"wo", "down"})                     # row-parallel


def _tp_local_cfg(cfg: ModelConfig, n: int) -> ModelConfig:
    if cfg.num_heads % n or cfg.num_kv_heads % n:
        raise ValueError(
            f"TP over {n} devices needs num_heads ({cfg.num_heads}) and "
            f"num_kv_heads ({cfg.num_kv_heads}) divisible by it")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // n, num_kv_heads=cfg.num_kv_heads // n)


def transformer_block_tp(
    layer: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d) replicated; SP: (B, S_local, d) seq shards
    *,
    positions: torch.Tensor,  # (B, S): the full sequence in both variants
    ctx=None,
    sequence_parallel: bool = False,
    seq_axis: int = 1,
) -> torch.Tensor:
    """The full explicit-TP transformer block on this rank's slice, running
    entirely on context collectives (``repro_torch.comms.api``): the
    per-rank counterpart of the reference's ``shard_map`` block, and equal
    in value to ``transformer_block_ref`` on the full layer.

    ``layer`` holds this rank's TP slices (``tp_block_specs`` names the
    split of each leaf, ``convert.shard_tp_layer`` cuts them): QKV and
    gate/up column-parallel, wo/down row-parallel, norms replicated.

    * **TP** (default): activations replicated; attention runs on the
      local heads, and both combine points are context-planned staged
      all-reduces.
    * **SP** (``sequence_parallel=True``): activations arrive
      sequence-sharded; the QKV projections share ONE context-planned
      all-gather (``api.allgather_matmul``: each gathered block projected
      the hop it lands), and both combines return to sequence shards via
      just-in-time ``api.matmul_reduce_scatter``.

    All mode/chunking/fusion/stage-order decisions come from the active
    :func:`repro_torch.comms.api.comm_context` (or the explicit ``ctx``).
    """
    from ..comms import api

    c = ctx if ctx is not None else api.current_context()
    names = c._names(None)
    lcfg = _tp_local_cfg(cfg, math.prod(c._sizes(names).values()))
    ap = layer["attn"]

    h = rmsnorm(layer["ln1"], x, cfg.norm_eps)
    if sequence_parallel:
        hg, (q, k, v) = api.allgather_matmul(
            h, (ap["wq"]["w"], ap["wk"]["w"], ap["wv"]["w"]), axis=seq_axis, ctx=c)
        # biases stay out of the fused ring: added once to the projections
        if "b" in ap["wq"]:
            q, k, v = q + ap["wq"]["b"], k + ap["wk"]["b"], v + ap["wv"]["b"]
        heads, _ = attention_heads(ap, lcfg, hg, positions=positions, qkv=(q, k, v))
        x = x + attention_tp_out_sp(ap, heads, seq_axis=seq_axis, ctx=c)
        h2 = rmsnorm(layer["ln2"], x, cfg.norm_eps)
        return x + ffn_apply_tp_sp(layer["ffn"], h2, seq_axis=seq_axis, ctx=c)

    heads, _ = attention_heads(ap, lcfg, h, positions=positions)
    x = x + attention_tp_out(ap, heads, ctx=c)
    h2 = rmsnorm(layer["ln2"], x, cfg.norm_eps)
    return x + ffn_apply_tp(layer["ffn"], h2, ctx=c)


def transformer_block_ref(
    layer: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    positions: torch.Tensor,
) -> torch.Tensor:
    """The same block on the full (unsharded) layer, on one device: the
    block that serving and training run (``_attn_block``, no KV cache)."""
    return _attn_block(cfg, layer, x, positions, None, 0)[0]


def tp_block_specs(layer: Dict, *, sequence_parallel: bool = False,
                   seq_axis: int = 1) -> Tuple[Optional[int], Dict]:
    """``(x_split, layer_specs)`` for ``transformer_block_tp``: the
    dimension of each leaf split over the TP axis tuple, the counterpart of
    the reference's ``shard_map`` in_specs.  QKV/gate/up are
    column-parallel (``-1``: the weight's columns, the bias itself), wo/down
    row-parallel (``0`` for the weight, ``None`` for a bias), everything
    else replicated (``None``); ``x`` is replicated (TP, ``None``) or split
    on ``seq_axis`` (SP).  ``convert.shard_tp_layer`` applies them."""

    def walk(tree, proj):
        out = {}
        for k, v in tree.items():
            p = k if k in _TP_COL | _TP_ROW else proj
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif p in _TP_COL:
                out[k] = -1
            elif p in _TP_ROW:
                out[k] = 0 if k == "w" else None
            else:
                out[k] = None
        return out

    return (seq_axis if sequence_parallel else None), walk(layer, None)
