"""Plain PyTorch versions of the kernels on the serving path.

Each function computes what its counterpart in ``repro/kernels/ref.py``
computes, in the same order of roundings, so the CPU tests can hold the
two packages to the reference's tolerances.  They are what a kernel
wrapper runs for a tensor on the CPU, and what ``chip_smoke.py`` compares
each hand-written kernel with on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "swiglu", "flash_attention", "flash_attention_chunked"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    # rounded to the input dtype before the scale multiply, as the oracle does
    return (x32 * rms).to(x.dtype) * scale


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


def _repeat_kv(t: torch.Tensor, rep: int) -> torch.Tensor:
    return t if rep == 1 else t.repeat_interleave(rep, dim=1)


def flash_attention(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, Hkv, T, hd)
    v: torch.Tensor,  # (B, Hkv, T, hd)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,  # (B, T) valid-key mask
) -> torch.Tensor:
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    rep = H // Hkv
    kx, vx = _repeat_kv(k, rep), _repeat_kv(v, rep)
    logits = torch.einsum("bhsd,bhtd->bhst", q, kx).float() * scale
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)  # cached prefix
        kpos = torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), vx)


def flash_attention_chunked(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, Hkv, T, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over key chunks: O(S*chunk) live memory in
    place of the O(S*T) logits.  Falls back to :func:`flash_attention`
    where the reference does (T not a multiple of ``chunk``, or one chunk).
    """
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if T % chunk or T <= chunk:
        return flash_attention(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask)
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    rep = H // Hkv
    cq = chunk if (S % chunk == 0 and S > chunk) else S  # query chunk
    dev = q.device
    outs = []
    for i in range(S // cq):
        q32 = q[:, :, i * cq:(i + 1) * cq].float()
        qpos = i * cq + torch.arange(cq, device=dev)[:, None] + (T - S)
        m = torch.full((B, H, cq), float("-inf"), device=dev)
        l = torch.zeros((B, H, cq), device=dev)
        acc = torch.zeros((B, H, cq, hd), device=dev)
        for j in range(T // chunk):
            keys = slice(j * chunk, (j + 1) * chunk)
            kj = _repeat_kv(k[:, :, keys].float(), rep)
            vj = _repeat_kv(v[:, :, keys].float(), rep)
            s = torch.einsum("bhsd,bhtd->bhst", q32, kj) * scale
            if causal:
                kpos = j * chunk + torch.arange(chunk, device=dev)[None, :]
                s = s.masked_fill(kpos > qpos, float("-inf"))
            if kv_mask is not None:
                s = s.masked_fill(~kv_mask[:, None, None, keys], float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhst,bhtd->bhsd", p, vj)
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / l[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)
