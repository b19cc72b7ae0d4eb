"""Plain PyTorch versions of the kernels on the serving path.

Each function computes what its counterpart in ``repro/kernels/ref.py``
computes, in the same order of roundings, so the CPU tests can hold the
two packages to the reference's tolerances.  They are what a kernel
wrapper runs for a tensor on the CPU, and what ``chip_smoke.py`` compares
each hand-written kernel with on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "swiglu", "flash_attention", "flash_attention_chunked", "rwkv6_scan",
           "mamba2_ssd_scan", "mamba2_ssd_scan_chunked"]


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


def rwkv6_scan(
    r: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, H, S, hd)
    v: torch.Tensor,  # (B, H, S, hd)
    w: torch.Tensor,  # (B, H, S, hd) decay in (0, 1), data-dependent
    u: torch.Tensor,  # (H, hd) bonus for the current token
    state: Optional[torch.Tensor] = None,  # (B, H, hd, hd); None: zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 linear-attention recurrence (Finch, arXiv:2404.05892)::

        y_t = r_t @ (S_t + diag(u) k_t v_t^T)
        S_{t+1} = diag(w_t) S_t + k_t v_t^T

    Returns (y in r's dtype, final state in f32); math in f32, one step at
    a time as the oracle's ``lax.scan``."""
    B, H, S, hd = r.shape
    r32, k32, v32, w32 = (a.float() for a in (r, k, v, w))
    u32 = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    ys = []
    for t in range(S):
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]  # (B, H, hd_k, hd_v)
        ys.append(torch.einsum("bhi,bhij->bhj", r32[:, :, t], s + u32 * kv))
        s = w32[:, :, t, :, None] * s + kv
    y = torch.stack(ys, dim=2) if ys else r32.new_zeros((B, H, 0, hd))
    return y.to(r.dtype), s


def mamba2_ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    Bmat: torch.Tensor,  # (B, S, N), shared across heads
    Cmat: torch.Tensor,  # (B, S, N), shared across heads
    decay: torch.Tensor,  # (B, S, H) = exp(dt * A)
    dt: torch.Tensor,  # (B, S, H)
    state: Optional[torch.Tensor] = None,  # (B, H, P, N); None: zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD recurrence (the inner loop of ``models.mamba2``)::

        h_t = decay_t * h_{t-1} + dt_t * (x_t B_t^T)
        y_t = h_t C_t

    Returns (y (B,S,H,P) f32, final state (B,H,P,N) f32); math in f32, one
    step at a time as the oracle's ``lax.scan``."""
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    x32, B32, C32 = x.float(), Bmat.float(), Cmat.float()
    dc32, dt32 = decay.float(), dt.float()
    ys = []
    for t in range(S):
        upd = dt32[:, t, :, None, None] * (x32[:, t, :, :, None] * B32[:, t, None, None, :])
        h = dc32[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, C32[:, t]))
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros((B, 0, H, P))
    return y, h


#: time steps per chunk of the SSD scan's chunked kernel (csrc/mamba2_ssd.cu: kL)
SSD_CHUNK = 32


def _split3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``a`` (f32) as three bf16 terms, each the rounding of what the ones
    before it leave (returned widened to f32): a0 + a1 + a2 keeps about 24
    of a's bits, so products with a bf16 operand lose almost nothing."""
    a0 = a.to(torch.bfloat16).float()
    r = a - a0
    a1 = r.to(torch.bfloat16).float()
    a2 = (r - a1).to(torch.bfloat16).float()
    return a0, a1, a2


def mamba2_ssd_scan_chunked(
    x: torch.Tensor,  # (B, S, H, P) bf16
    Bmat: torch.Tensor,  # (B, S, N) bf16
    Cmat: torch.Tensor,  # (B, S, N) bf16
    decay: torch.Tensor,  # (B, S, H) f32
    dt: torch.Tensor,  # (B, S, H) f32
    state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32; None: zeros
    *,
    chunk: int = SSD_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba2_ssd_scan` in the chunked (SSD) form, computed as the
    CUDA kernel's chunked route computes it; used by the tests and
    ``chip_smoke.py`` only.  Per chunk of ``chunk`` steps (the last may be
    shorter), with D[t, s] = decay_{s+1} ... decay_t (1 on the diagonal)
    taken as a running product down each column s, so a decay of exactly 0
    gives 0 and never 0/0::

        G = C B^T                        bf16 x bf16, exact products, f32 sums
        M[t, s] = G[t, s] * (D[t, s] dt_s)              for s <= t, else 0
        y = D[t, -1] * (C h^T) + M X     D[t, -1] = decay_0 ... decay_t
        h <- D[L-1, -1] h + (X * w)^T B   w_s = D[L-1, s] dt_s

    Each product with an f32 operand (h, M, X * w) takes that operand as
    three bf16 terms (``_split3``) against the bf16 one, as the kernel's
    tensor-core products do.  Returns (y (B,S,H,P) f32, final state
    (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    x32, B32, C32 = x.float(), Bmat.float(), Cmat.float()
    ys = []
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        xc, bc, cc = x32[:, c0:c0 + L], B32[:, c0:c0 + L], C32[:, c0:c0 + L]
        dc = decay[:, c0:c0 + L].float().transpose(1, 2)  # (B, H, L)
        dtc = dt[:, c0:c0 + L].float().transpose(1, 2)
        t = torch.arange(L, device=x.device)
        below = t[:, None] > t[None, :]  # (t, s): s < t
        fac = torch.where(below, dc[..., :, None], torch.ones((), device=x.device))
        D = torch.cumprod(fac, dim=-2).masked_fill(t[:, None] < t[None, :], 0.0)
        D0 = torch.cumprod(dc, dim=-1)  # (B, H, L): decay_0 ... decay_t
        W = D * dtc[..., None, :]  # (B, H, t, s)
        M = torch.einsum("btn,bsn->bts", cc, bc)[:, None] * W
        inter = sum(torch.einsum("btn,bhpn->bthp", cc, hk) for hk in _split3(h))
        intra = sum(torch.einsum("bhts,bshp->bthp", mk, xc) for mk in _split3(M))
        ys.append(inter * D0.transpose(1, 2)[..., None] + intra)
        xw = xc * W[:, :, -1].transpose(1, 2)[..., None]  # (B, L, H, P)
        upd = sum(torch.einsum("bshp,bsn->bhpn", xk, bc) for xk in _split3(xw))
        h = h * D0[:, :, -1, None, None] + upd
    y = torch.cat(ys, dim=1) if ys else x32.new_zeros((B, 0, H, P))
    return y, h
