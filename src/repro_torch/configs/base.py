"""Model configuration for the port: a framework-free copy of
``repro/configs/base.py``.

The config dataclasses, ``reduced``, ``param_count``,
``active_param_count`` and the expert-parallel knob ``expert_parallel`` are
copied field for field, so a config means the same model in both packages.
The input-shape cells (``ShapeConfig``, ``input_specs``) are left out
(ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "ModelConfig",
    "expert_parallel",
    "reduced",
    "param_count",
    "active_param_count",
]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False  # llama4-style always-on expert
    dense_residual: bool = False  # arctic-style parallel dense FFN branch
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    # expert parallelism: mesh axis the experts are sharded over.  When set
    # AND the active comm_context's mesh has this axis, moe_block
    # dispatches/combines across the mesh through the context-planned
    # ``repro_torch.comms.api.all_to_all`` (num_experts must divide by the
    # axis size).  None = every device holds all experts.
    expert_axis: Optional[str] = None


@dataclass(frozen=True)
class SSMConfig:
    kind: str  # 'rwkv6' | 'mamba2'
    head_dim: int = 64  # rwkv6 head size / mamba2 P
    state_dim: int = 64  # mamba2 N (ssm_state)
    expand: int = 2  # mamba2 inner expansion
    conv_dim: int = 4  # mamba2 short conv width
    scan_chunk: int = 0  # >0: remat the time scan per chunk (trains long seqs)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    causal: bool = True  # False => encoder-only (hubert)
    logit_softcap: float = 0.0
    # norm / embeddings
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # substructure
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0  # zamba2: shared attn block every k-th layer
    # modality frontend stubs (assignment: embeddings are precomputed inputs)
    frontend: Optional[str] = None  # 'vision' | 'audio'
    num_prefix_embeds: int = 0  # vision patch slots in the token stream
    # numerics / distribution defaults
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # 'full' | 'dots' (checkpoint_dots_with_no_batch_dims)
    sequence_parallel: bool = True  # train-time; launcher gates by step kind
    scan_layers: bool = True
    kv_shard: str = "auto"  # KV-cache layout: 'auto' | 'heads' | 'seq'
    fsdp: bool = False  # shard params over 'data' too (ZeRO-3-style)
    opt_state_dtype: str = "float32"  # 'bfloat16' halves m/v HBM
    opt_use_master: bool = True  # False: master-free AdamW (4 B/param total)
    grad_accum: int = 1  # microbatches per step (activation memory / N)
    loss_chunk: int = 512  # seq-chunked vocab xent (never materializes B,S,V)
    vocab_align: int = 256  # embed/head padded so vocab shards evenly

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        a = self.vocab_align
        return ((self.vocab_size + a - 1) // a) * a

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm" or self.hybrid_attn_every > 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic token mixing => the 500k decode shape is runnable."""
        return self.family in ("ssm", "hybrid")


def expert_parallel(cfg: ModelConfig, axis: str = "data") -> ModelConfig:
    """The expert-parallel variant of an MoE config: experts sharded over
    mesh axis ``axis``, dispatch/combine crossing the mesh through
    ``repro_torch.comms.api.all_to_all`` (no config hand-editing)."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE block to expert-parallelize")
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, expert_axis=axis))


# --------------------------------------------------------------------------
# reduced configs for CPU smoke tests
# --------------------------------------------------------------------------
def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config: few layers, narrow width, tiny vocab."""
    changes: Dict = dict(
        num_layers=2 if cfg.hybrid_attn_every == 0 else max(2, cfg.hybrid_attn_every),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_prefix_embeds=4 if cfg.frontend == "vision" else 0,
        dtype="float32",
        remat=False,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=128
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, head_dim=16, state_dim=8)
    if cfg.hybrid_attn_every:
        changes["hybrid_attn_every"] = 2
        changes["num_layers"] = 4
    return dataclasses.replace(cfg, **changes)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (used for 6*N*D model-flops in the roofline)."""
    d, L = cfg.d_model, cfg.num_layers
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.qkv_bias:
        attn += cfg.q_dim + 2 * cfg.kv_dim
    per_layer = 2 * d  # norms
    if cfg.family == "ssm" and cfg.ssm and cfg.ssm.kind == "rwkv6":
        h = d // cfg.ssm.head_dim
        tmix = 4 * d * d + d * d  # r,k,v,g,o projections
        tmix += 6 * d + 2 * d  # decay/tokenshift params (approx; small)
        cmix = d * cfg.d_ff + cfg.d_ff * d
        per_layer += tmix + cmix
    elif cfg.family in ("hybrid",) and cfg.ssm and cfg.ssm.kind == "mamba2":
        d_in = cfg.ssm.expand * d
        mamba = d * (2 * d_in + 2 * cfg.ssm.state_dim)  # in_proj (z,x,B,C)
        mamba += d_in // cfg.ssm.head_dim  # dt per head
        mamba += d_in * d  # out proj
        per_layer += mamba + d * cfg.d_ff * 3 // 2  # + glu mlp approx
    else:
        per_layer += attn
        if cfg.moe is not None:
            e = cfg.moe
            expert = 3 * d * e.d_ff_expert
            per_layer += e.num_experts * expert + d * e.num_experts
            if e.shared_expert:
                per_layer += expert
            if e.dense_residual:
                per_layer += 3 * d * cfg.d_ff
        else:
            per_layer += 3 * d * cfg.d_ff  # swiglu
    total = L * per_layer
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.hybrid_attn_every:
        total += attn  # one shared attention block
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active-per-token params (MoE: top_k + shared + dense residual only)."""
    if cfg.moe is None:
        return param_count(cfg)
    full = param_count(cfg)
    e = cfg.moe
    d = cfg.d_model
    expert = 3 * d * e.d_ff_expert
    inactive = (e.num_experts - e.top_k) * expert * cfg.num_layers
    return full - inactive
