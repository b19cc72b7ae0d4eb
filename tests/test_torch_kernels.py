"""The port's kernel modules on the CPU against the JAX package.

Every input is drawn with numpy from a fixed seed and handed to both
packages.  Each plain PyTorch version (what a kernel wrapper runs for a CPU
tensor) is held to ``repro.kernels.ref`` and to the Pallas kernel in
interpret mode, at the shapes of ``tests/test_kernels.py`` and with its
tolerances (f32 1e-5, bf16 2e-2, flash f32 2e-4, WKV6 and SSD f32 1e-4).  The wrappers' input
checks are exercised here too; the CUDA kernels themselves run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention_pallas, rmsnorm_pallas, swiglu_pallas
from repro.kernels.mamba2_scan import mamba2_ssd_pallas
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_scan
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.swiglu import swiglu
from repro_torch.kernels.wkv6 import rwkv6_scan

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
#: tests/test_kernels.py's WKV6 tolerance; bf16 y as the other kernels, and
#: the f32 state from bf16 inputs within 1e-4 as in f32
WKV6_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(rng, shape, dtype, mul=1.0, add=0.0):
    """The same values as a jax array and a torch tensor (both round the f32
    draw to bf16 the same way, to nearest even)."""
    x = (rng.normal(size=shape) * mul + add).astype(np.float32)
    return jnp.asarray(x, dtype=getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (3, 5, 256), (2, 7, 384), (1, 1, 512)])
def test_rmsnorm_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, shape, dtype)
    js, ts = _pair(rng, shape[-1:], dtype, mul=0.1, add=1.0)
    got = _np(rmsnorm(tx, ts))
    np.testing.assert_allclose(got, _np(jref.rmsnorm(jx, js)), **TOL[dtype])
    np.testing.assert_allclose(got, _np(rmsnorm_pallas(jx, js, interpret=True)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 512), (5, 77), (1, 1000)])
def test_swiglu_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(2)
    (jg, tg), (ju, tu) = _pair(rng, shape, dtype), _pair(rng, shape, dtype)
    got = _np(swiglu(tg, tu))
    np.testing.assert_allclose(got, _np(jref.swiglu(jg, ju)), **TOL[dtype])
    np.testing.assert_allclose(got, _np(swiglu_pallas(jg, ju, interpret=True)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,Hkv,S,hd,causal",
    [
        (1, 2, 2, 128, 64, True),
        (2, 4, 2, 256, 64, True),  # GQA
        (1, 8, 2, 128, 128, True),
        (2, 2, 1, 256, 32, False),  # non-causal
        (1, 2, 2, 200, 64, True),  # ragged S
        (1, 4, 2, 24, 16, True),  # the reduced configs' head_dim
    ],
)
def test_flash_attention_plain_matches_reference(B, H, Hkv, S, hd, causal, dtype):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (B, H, S, hd), dtype, mul=0.5)
    jk, tk = _pair(rng, (B, Hkv, S, hd), dtype, mul=0.5)
    jv, tv = _pair(rng, (B, Hkv, S, hd), dtype)
    got = _np(flash_attention(tq, tk, tv, causal=causal))
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got, _np(jref.flash_attention(jq, jk, jv, causal=causal)), **tol)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, interpret=True,
                                    block_q=64, block_k=64)
    np.testing.assert_allclose(got, _np(pallas), **tol)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True), (True, True)])
def test_flash_attention_chunked_matches_reference(causal, masked):
    rng = np.random.default_rng(4)
    B, H, Hkv, S, T, hd, chunk = 2, 4, 2, 32, 64, 16, 16
    jq, tq = _pair(rng, (B, H, S, hd), "float32", mul=0.5)
    jk, tk = _pair(rng, (B, Hkv, T, hd), "float32", mul=0.5)
    jv, tv = _pair(rng, (B, Hkv, T, hd), "float32")
    mask = (rng.random((B, T)) < 0.8) if masked else None
    if masked:
        mask[:, 0] = True  # every query keeps a key in the first chunk
    kw = dict(causal=causal, chunk=chunk)
    want = jref.flash_attention_chunked(
        jq, jk, jv, kv_mask=None if mask is None else jnp.asarray(mask), **kw)
    got = ref.flash_attention_chunked(
        tq, tk, tv, kv_mask=None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **FLASH_TOL["float32"])


def test_ops_flash_dispatch_matches_reference_ops():
    """Decode with a kv_mask takes the plain masked path; long prefill on
    the CPU takes the chunked path above FLASH_CHUNK_THRESHOLD, as the
    reference's ref backend does."""
    assert ops.FLASH_CHUNK_THRESHOLD == jops.FLASH_CHUNK_THRESHOLD
    assert ops.FLASH_CHUNK == jops.FLASH_CHUNK
    rng = np.random.default_rng(5)
    B, H, Hkv, T, hd = 2, 4, 2, 40, 16
    jq, tq = _pair(rng, (B, H, 1, hd), "float32")
    jk, tk = _pair(rng, (B, Hkv, T, hd), "float32")
    jv, tv = _pair(rng, (B, Hkv, T, hd), "float32")
    valid = np.arange(T)[None, :] <= np.array([[7], [30]])
    want = jops.flash_attention(jq, jk, jv, causal=False, kv_mask=jnp.asarray(valid))
    got = ops.flash_attention(tq, tk, tv, causal=False, kv_mask=torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), _np(want), **FLASH_TOL["float32"])

    S = T = ops.FLASH_CHUNK_THRESHOLD + ops.FLASH_CHUNK  # chunked branch, 5 chunks
    q = torch.from_numpy(rng.normal(size=(1, 1, S, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, T, 16)).astype(np.float32))
    got = ops.flash_attention(q, k, k, causal=True)
    want = ref.flash_attention_chunked(q, k, k, causal=True, chunk=ops.FLASH_CHUNK)
    assert torch.equal(got, want)


def _wkv6_inputs(rng, B, H, S, hd, dtype):
    """r, k, v, the decay as the model makes it (exp(-exp(w0 + lora)) with
    w0 near -6, so near 1), u and a non-zero initial state, as jax/torch
    pairs."""
    r, k = _pair(rng, (B, H, S, hd), dtype, mul=0.5), _pair(rng, (B, H, S, hd), dtype, mul=0.5)
    v = _pair(rng, (B, H, S, hd), dtype)
    w_log = rng.normal(size=(B, H, S, hd)) * 0.5 - 6.0 + rng.normal(size=(1, H, 1, hd)) * 2
    w = np.exp(-np.exp(w_log)).astype(np.float32)
    w = jnp.asarray(w, getattr(jnp, dtype)), torch.from_numpy(w).to(getattr(torch, dtype))
    u = _pair(rng, (H, hd), "float32", mul=0.1)
    s0 = _pair(rng, (B, H, hd, hd), "float32")
    return r, k, v, w, u, s0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,hd", [(1, 2, 64, 16), (2, 3, 128, 32), (2, 4, 24, 16),
                                      (1, 2, 1, 64), (2, 1, 40, 64)])
def test_rwkv6_scan_plain_matches_reference(B, H, S, hd, dtype):
    rng = np.random.default_rng(6)
    pairs = _wkv6_inputs(rng, B, H, S, hd, dtype)
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    y, s = rwkv6_scan(*targs)
    assert y.dtype == targs[0].dtype and s.dtype == torch.float32
    tol = WKV6_TOL[dtype]
    want_y, want_s = jref.rwkv6_scan(*jargs)
    np.testing.assert_allclose(_np(y), _np(want_y), **tol)
    np.testing.assert_allclose(_np(s), _np(want_s), **WKV6_TOL["float32"])
    # several chunks where S allows, so the state crosses the Pallas grid
    pal_y, pal_s = rwkv6_scan_pallas(*jargs, chunk=32 if S % 32 == 0 else S, interpret=True)
    np.testing.assert_allclose(_np(y), _np(pal_y), **tol)
    np.testing.assert_allclose(_np(s), _np(pal_s), **WKV6_TOL["float32"])


def test_rwkv6_scan_state_none_is_zeros():
    rng = np.random.default_rng(7)
    r, k, v, w, u, _ = (p[1] for p in _wkv6_inputs(rng, 2, 2, 9, 16, "float32"))
    y0, s0 = rwkv6_scan(r, k, v, w, u)
    y1, s1 = rwkv6_scan(r, k, v, w, u, torch.zeros(2, 2, 16, 16))
    assert torch.equal(y0, y1) and torch.equal(s0, s1)


@pytest.mark.parametrize("split", [1, 17, 32])
def test_rwkv6_scan_state_chaining(split):
    """Two runs chained through the returned state equal one run (the
    decode path: a prompt, then one token at a time)."""
    rng = np.random.default_rng(8)
    r, k, v, w, u, s0 = (p[1] for p in _wkv6_inputs(rng, 1, 2, 64, 16, "float32"))
    y_full, s_full = ops.rwkv6_scan(r, k, v, w, u, s0)
    head = [a[:, :, :split].contiguous() for a in (r, k, v, w)]
    tail = [a[:, :, split:].contiguous() for a in (r, k, v, w)]
    y1, s1 = ops.rwkv6_scan(*head, u, s0)
    y2, s2 = ops.rwkv6_scan(*tail, u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y_full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, s_full, rtol=1e-5, atol=1e-5)


def test_rwkv6_scan_wrapper_checks_raise():
    x, u = torch.ones(1, 2, 8, 16), torch.ones(2, 16)
    with pytest.raises(TypeError):
        rwkv6_scan(x.half(), x.half(), x.half(), x.half(), u)
    with pytest.raises(TypeError):
        rwkv6_scan(x, x, x.bfloat16(), x, u)
    with pytest.raises(ValueError):
        rwkv6_scan(x, x, x, torch.ones(1, 2, 9, 16), u)
    with pytest.raises(ValueError, match="head_dim"):
        rwkv6_scan(*[torch.ones(1, 2, 8, 24)] * 4, torch.ones(2, 24))
    with pytest.raises(ValueError, match="u as"):
        rwkv6_scan(x, x, x, x, u.bfloat16())
    with pytest.raises(ValueError, match="u as"):
        rwkv6_scan(x, x, x, x, torch.ones(3, 16))
    with pytest.raises(ValueError, match="state as"):
        rwkv6_scan(x, x, x, x, u, torch.ones(1, 2, 16, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, x, u)
    with pytest.raises(ValueError):
        rwkv6_scan(*[x.to("meta")] * 4, u.to("meta"))


def test_plain_versions_do_not_count_launches():
    before = {n: k.launches for n, k in KERNELS.items()}
    x = torch.ones(3, 16)
    rmsnorm(x, torch.ones(16))
    swiglu(x, x)
    flash_attention(torch.ones(1, 2, 4, 16), torch.ones(1, 1, 4, 16), torch.ones(1, 1, 4, 16))
    rwkv6_scan(*[torch.ones(1, 2, 4, 16)] * 4, torch.ones(2, 16))
    assert {n: k.launches for n, k in KERNELS.items()} == before


# --------------------------------------------------------------------------
# the wrappers' checks: what the kernel does not take raises on every device
# --------------------------------------------------------------------------
def test_rmsnorm_wrapper_checks_raise():
    x = torch.ones(4, 32)
    with pytest.raises(TypeError):
        rmsnorm(x.half(), torch.ones(32).half())
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(32, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(16))
    with pytest.raises(ValueError):
        rmsnorm(torch.ones(32, 4).t(), torch.ones(32))  # not contiguous
    with pytest.raises(ValueError):
        rmsnorm(x.to("meta"), torch.ones(32, device="meta"))  # neither cpu nor cuda


def test_swiglu_wrapper_checks_raise():
    g = torch.ones(4, 32)
    with pytest.raises(TypeError):
        swiglu(g.half(), g.half())
    with pytest.raises(TypeError):
        swiglu(g, g.bfloat16())
    with pytest.raises(ValueError):
        swiglu(g, torch.ones(4, 16))
    with pytest.raises(ValueError):
        swiglu(torch.ones(32, 4).t(), torch.ones(4, 32))
    with pytest.raises(ValueError):
        swiglu(g.to("meta"), g.to("meta"))


def test_flash_attention_wrapper_checks_raise():
    q, kv = torch.ones(1, 4, 8, 16), torch.ones(1, 2, 8, 16)
    with pytest.raises(ValueError, match="S == T"):
        flash_attention(q, torch.ones(1, 2, 12, 16), torch.ones(1, 2, 12, 16), causal=True)
    flash_attention(q, torch.ones(1, 2, 12, 16), torch.ones(1, 2, 12, 16), causal=False)
    with pytest.raises(TypeError):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.ones(1, 4, 8, 24), torch.ones(1, 2, 8, 24), torch.ones(1, 2, 8, 24))
    with pytest.raises(ValueError):
        flash_attention(q, torch.ones(1, 3, 8, 16), torch.ones(1, 3, 8, 16))  # H % Hkv
    with pytest.raises(ValueError):
        flash_attention(q, kv, torch.ones(1, 2, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference_at_head_dim_80(dtype):
    """zamba2's shared attention block: 32 heads of 80, MHA."""
    rng = np.random.default_rng(9)
    B, H, S, hd = 1, 4, 96, 80
    jq, tq = _pair(rng, (B, H, S, hd), dtype, mul=0.5)
    jk, tk = _pair(rng, (B, H, S, hd), dtype, mul=0.5)
    jv, tv = _pair(rng, (B, H, S, hd), dtype)
    got = _np(flash_attention(tq, tk, tv, causal=True))
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got, _np(jref.flash_attention(jq, jk, jv, causal=True)), **tol)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True,
                                    block_q=32, block_k=32)
    np.testing.assert_allclose(got, _np(pallas), **tol)


# --------------------------------------------------------------------------
# the Mamba2 SSD scan
# --------------------------------------------------------------------------
def _ssd_inputs(rng, B, S, H, P, N, dtype):
    """x, B, C in ``dtype``, decay and dt in f32 as the model passes them,
    and a non-zero f32 initial state, as jax/torch pairs.  The ranges are
    tests/test_kernels.py's (x, B, C times 0.5, decay in [0.6, 0.95], dt in
    [0.1, 0.9])."""
    x = _pair(rng, (B, S, H, P), dtype, mul=0.5)
    Bm, Cm = _pair(rng, (B, S, N), dtype, mul=0.5), _pair(rng, (B, S, N), dtype, mul=0.5)

    def uniform(lo, hi):
        a = rng.uniform(lo, hi, (B, S, H)).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    decay, dt = uniform(0.6, 0.95), uniform(0.1, 0.9)
    s0 = _pair(rng, (B, H, P, N), "float32")
    return x, Bm, Cm, decay, dt, s0


#: tests/test_kernels.py's SSD tolerance, for y and the state; from bf16
#: x, B and C both sides widen the same values to f32 and run the same f32
#: recurrence, so it holds there too
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,P,N,chunk", [(1, 2, 64, 16, 8, 32), (2, 2, 32, 8, 8, 32)])
def test_mamba2_ssd_scan_plain_matches_reference(B, H, S, P, N, chunk, dtype):
    """tests/test_kernels.py's shapes (S a multiple of chunk), from a
    non-zero state."""
    rng = np.random.default_rng(10)
    pairs = _ssd_inputs(rng, B, S, H, P, N, dtype)
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    y, s = mamba2_ssd_scan(*targs)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(s.shape) == (B, H, P, N)
    want_y, want_s = jref.mamba2_ssd_scan(*jargs)
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOL)
    np.testing.assert_allclose(_np(s), _np(want_s), **SSD_TOL)
    pal_y, pal_s = mamba2_ssd_pallas(*jargs, chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(y), _np(pal_y), **SSD_TOL)
    np.testing.assert_allclose(_np(s), _np(pal_s), **SSD_TOL)


def test_mamba2_ssd_scan_state_none_is_zeros():
    rng = np.random.default_rng(11)
    x, Bm, Cm, dc, dt, _ = (p[1] for p in _ssd_inputs(rng, 2, 9, 3, 16, 8, "float32"))
    y0, s0 = mamba2_ssd_scan(x, Bm, Cm, dc, dt)
    y1, s1 = mamba2_ssd_scan(x, Bm, Cm, dc, dt, torch.zeros(2, 3, 16, 8))
    assert torch.equal(y0, y1) and torch.equal(s0, s1)


@pytest.mark.parametrize("split", [1, 17, 32])
def test_mamba2_ssd_scan_state_chaining(split):
    """Two runs chained through the returned state equal one run (the
    decode path: a prompt, then one token at a time)."""
    rng = np.random.default_rng(12)
    x, Bm, Cm, dc, dt, s0 = (p[1] for p in _ssd_inputs(rng, 1, 64, 2, 16, 8, "float32"))
    y_full, s_full = ops.mamba2_ssd_scan(x, Bm, Cm, dc, dt, s0)
    head = [a[:, :split] for a in (x, Bm, Cm, dc, dt)]
    tail = [a[:, split:] for a in (x, Bm, Cm, dc, dt)]
    y1, s1 = ops.mamba2_ssd_scan(*head[:3], *(a.contiguous() for a in head[3:]), s0)
    y2, s2 = ops.mamba2_ssd_scan(*tail[:3], *(a.contiguous() for a in tail[3:]), s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, s_full, rtol=1e-5, atol=1e-5)


def test_mamba2_ssd_scan_takes_the_models_strided_views():
    """x, B and C as the model's split of one (B, S, H*P + 2N) buffer gives
    them (time stride H*P + 2N) give what contiguous copies give."""
    rng = np.random.default_rng(13)
    B, S, H, P, N = 2, 7, 3, 16, 8
    buf = torch.from_numpy(rng.normal(size=(B, S, H * P + 2 * N)).astype(np.float32))
    x = buf[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = buf[..., H * P:H * P + N], buf[..., H * P + N:]
    assert not (x.is_contiguous() or Bm.is_contiguous() or Cm.is_contiguous())
    dt = torch.from_numpy(rng.uniform(0.1, 0.9, (B, S, H)).astype(np.float32))
    dc = torch.exp(-dt)
    got = mamba2_ssd_scan(x, Bm, Cm, dc, dt)
    want = mamba2_ssd_scan(x.contiguous(), Bm.contiguous(), Cm.contiguous(), dc, dt)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mamba2_ssd_scan_wrapper_checks_raise():
    B, S, H, P, N = 1, 4, 2, 16, 8
    x, bc, hd = torch.ones(B, S, H, P), torch.ones(B, S, N), torch.ones(B, S, H)
    with pytest.raises(TypeError):
        mamba2_ssd_scan(x.half(), bc.half(), bc.half(), hd, hd)
    with pytest.raises(TypeError):
        mamba2_ssd_scan(x, bc.bfloat16(), bc, hd, hd)
    with pytest.raises(ValueError):
        mamba2_ssd_scan(x[0], bc, bc, hd, hd)
    with pytest.raises(ValueError, match="B and C"):
        mamba2_ssd_scan(x, torch.ones(B, S + 1, N), bc, hd, hd)
    with pytest.raises(ValueError, match="state_dim"):
        mamba2_ssd_scan(x, torch.ones(B, S, 12), torch.ones(B, S, 12), hd, hd)
    with pytest.raises(ValueError, match="head_dim"):
        mamba2_ssd_scan(torch.ones(B, S, H, 129), bc, bc, hd, hd)
    with pytest.raises(ValueError, match="decay as"):
        mamba2_ssd_scan(x, bc, bc, hd.bfloat16(), hd)
    with pytest.raises(ValueError, match="dt as"):
        mamba2_ssd_scan(x, bc, bc, hd, torch.ones(B, S, H + 1))
    with pytest.raises(ValueError, match="state as"):
        mamba2_ssd_scan(x, bc, bc, hd, hd, torch.ones(B, H, P, N, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), bc, bc, hd, hd)
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_ssd_scan(x, bc, bc, torch.ones(B, H, S).transpose(1, 2), hd)
    with pytest.raises(ValueError):
        mamba2_ssd_scan(x.to("meta"), bc.to("meta"), bc.to("meta"), hd.to("meta"),
                        hd.to("meta"))
    before = KERNELS["mamba2_ssd"].launches
    mamba2_ssd_scan(x, bc, bc, hd, hd)  # the plain version: no launch counted
    assert KERNELS["mamba2_ssd"].launches == before


def _ssd_decays_with_exact_zero_and_one(rng, B, S, H):
    """decay as the model makes it, exp(-softplus(normal)), with exactly 0
    at one step and exactly 1 over ten steps where S has room."""
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    decay = np.exp(-dt).astype(np.float32)
    if S > 1:
        decay[:, S // 3] = 0.0
        decay[:, S // 2:S // 2 + 10] = 1.0
    return decay, dt


@pytest.mark.parametrize(
    "S,P,N,with_state,edge_decays",
    [
        (1, 16, 16, True, False),  # decode
        (37, 64, 64, False, True),  # a chunk and a ragged one
        (64, 16, 64, True, True),  # whole chunks only
        (65, 64, 16, True, True),  # whole chunks and one step
        (130, 16, 16, False, False),  # four chunks and a ragged one
    ],
)
def test_mamba2_ssd_scan_chunked_matches_reference(S, P, N, with_state, edge_decays):
    """The kernel's chunked form (running products of the decays, bf16
    three-term splits of each f32 operand, 32-step chunks) against the
    reference's sequential scan and the Pallas kernel, from bf16 x, B and
    C, at the SSD tolerance; with decays of exactly 0 and 1."""
    rng = np.random.default_rng(14)
    B, H = 2, 2
    pairs = _ssd_inputs(rng, B, S, H, P, N, "bfloat16")
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    if edge_decays:
        decay, dt = _ssd_decays_with_exact_zero_and_one(rng, B, S, H)
        jargs[3:5] = [jnp.asarray(decay), jnp.asarray(dt)]
        targs[3:5] = [torch.from_numpy(decay), torch.from_numpy(dt)]
    if not with_state:
        jargs, targs = jargs[:5], targs[:5]
    y, s = ref.mamba2_ssd_scan_chunked(*targs)
    assert tuple(y.shape) == (B, S, H, P) and tuple(s.shape) == (B, H, P, N)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    want_y, want_s = jref.mamba2_ssd_scan(*jargs)
    np.testing.assert_allclose(_np(y), _np(want_y), **SSD_TOL)
    np.testing.assert_allclose(_np(s), _np(want_s), **SSD_TOL)
    chunk = max(c for c in range(1, 65) if S % c == 0)  # the Pallas wrapper's rule
    pal_y, pal_s = mamba2_ssd_pallas(*jargs, chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(y), _np(pal_y), **SSD_TOL)
    np.testing.assert_allclose(_np(s), _np(pal_s), **SSD_TOL)


@pytest.mark.parametrize("header", ["common.cuh", "mma.cuh"])
def test_library_path_changes_with_every_header(header, tmp_path, monkeypatch):
    """A kernel's library is named by a digest that covers each header in
    csrc/, so an edited header is rebuilt, never loaded stale."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    kernel = KERNELS["mamba2_ssd"]
    before = kernel.library_path
    assert kernel.library_path == before  # the same bytes, the same name
    (csrc / header).write_bytes((csrc / header).read_bytes() + b"\n// edited\n")
    assert kernel.library_path != before
    assert kernel.library_path.parent == before.parent
