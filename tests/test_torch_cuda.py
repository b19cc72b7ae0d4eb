"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and carries the ``cuda`` marker; the
``card`` fixture skips it, at run time, where there is none.  The file
imports torch and the port only (no jax), so it runs on a machine that has
no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which initialises JAX.)
"""
import pytest
import torch

from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_scan, route
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.swiglu import swiglu
from repro_torch.kernels.wkv6 import rwkv6_scan

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
#: WKV6 y as tests/test_kernels.py holds the Pallas kernel (f32) and as the
#: other kernels (bf16); the f32 state
WKV6_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
WKV6_STATE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
                  torch.bfloat16: dict(rtol=1e-3, atol=1e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(card, *shape, dtype, mul=1.0, add=0.0, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=card) * mul + add).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 128), (3, 5, 256), (2, 7, 384), (1, 1, 512), (6, 2048),
                                   # the serving widths, decode (4) and prefill (4 x 445) rows
                                   (1780, 2048), (4, 2560), (1780, 2560), (4, 4096),
                                   (1780, 4096), (8, 4, 128),
                                   # phi-3-vision's and hubert-xlarge's widths
                                   (4, 3072), (1780, 3072), (4, 1280), (4096, 1280),
                                   (5, 100)])  # d not a multiple of the 16-byte chunk
def test_rmsnorm_kernel_matches_plain(card, shape, dtype):
    x = _randn(card, *shape, dtype=dtype)
    scale = _randn(card, shape[-1], dtype=dtype, mul=0.1, add=1.0, seed=1)
    before = KERNELS["rmsnorm"].launches
    got = rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert KERNELS["rmsnorm"].launches == before + 1
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, scale).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2048, 100])
def test_rmsnorm_kernel_unaligned(card, d, dtype):
    """x a view one element past a 16-byte boundary: the element-wise path."""
    rows = 7
    x = _randn(card, rows * d + 1, dtype=dtype)[1:].view(rows, d)
    scale = _randn(card, d, dtype=dtype, mul=0.1, add=1.0, seed=1)
    before = KERNELS["rmsnorm"].launches
    got = rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert KERNELS["rmsnorm"].launches == before + 1
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, scale).float(), **TOL[dtype])


def test_rmsnorm_kernel_refuses_rows_past_its_registers(card):
    """A row is held in registers, 4 chunks of 16 bytes a thread at most
    1024 threads: a longer one raises, and launches nothing."""
    from repro_torch.kernels.rmsnorm import MAX_CHUNKS

    d = 4 * MAX_CHUNKS + 4  # f32: one chunk past the limit
    x = torch.ones(1, d, device=card)
    before = KERNELS["rmsnorm"].launches
    with pytest.raises(ValueError, match="at most"):
        rmsnorm(x, torch.ones(d, device=card))
    assert KERNELS["rmsnorm"].launches == before
    got = rmsnorm(x[:, :-4].contiguous(), torch.ones(d - 4, device=card))  # at the limit
    torch.testing.assert_close(got, torch.ones_like(got), **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 512), (5, 77), (1, 1000), (4, 8192)])
def test_swiglu_kernel_matches_plain(card, shape, dtype):
    g, u = _randn(card, *shape, dtype=dtype), _randn(card, *shape, dtype=dtype, seed=1)
    before = KERNELS["swiglu"].launches
    got = swiglu(g, u)
    torch.cuda.synchronize()
    assert KERNELS["swiglu"].launches == before + 1
    torch.testing.assert_close(got.float(), ref.swiglu(g, u).float(), **TOL[dtype])


def test_swiglu_kernel_unaligned(card):
    g = _randn(card, 1001, dtype=torch.bfloat16)[1:]
    u = _randn(card, 1001, dtype=torch.bfloat16, seed=1)[1:]
    torch.testing.assert_close(swiglu(g, u).float(), ref.swiglu(g, u).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,Hkv,S,T,hd,causal",
    [
        (1, 2, 2, 128, 128, 64, True),
        (2, 4, 2, 256, 256, 64, True),
        (1, 8, 2, 128, 128, 128, True),
        (2, 2, 1, 256, 256, 32, False),
        (1, 2, 2, 200, 200, 64, True),  # ragged S
        (1, 4, 2, 24, 24, 16, True),
        (2, 4, 1, 37, 101, 64, False),  # non-causal, ragged S and T
        (2, 32, 32, 200, 200, 80, True),  # zamba2's shared block: hd 80, MHA
        (1, 4, 4, 64, 96, 80, False),
        # the smoke serves' prompt lengths, and tiles shorter than one block
        (1, 2, 2, 71, 71, 64, True),
        (1, 2, 2, 445, 445, 64, True),
        (2, 2, 2, 1, 1, 64, True),
        (1, 2, 2, 15, 15, 64, True),
        (1, 2, 2, 64, 64, 64, True),
        (1, 8, 2, 445, 445, 64, True),  # granite's GQA rep 4
        (1, 4, 4, 71, 71, 80, True),
        (1, 2, 2, 200, 200, 128, True),
        (1, 4, 1, 200, 328, 64, False),
        # phi-3-vision: hd 96, MHA, at the prompt lengths and past a tile
        (1, 4, 4, 71, 71, 96, True),
        (1, 4, 4, 1, 1, 96, True),
        (2, 32, 32, 200, 200, 96, True),
        (1, 4, 4, 576, 576, 96, True),
        (1, 2, 2, 100, 37, 96, False),
        # hubert-xlarge's encoder: non-causal, 16 heads of 80, ragged frames
        (1, 16, 16, 781, 781, 80, False),
        (2, 16, 16, 128, 128, 80, False),
    ],
)
def test_flash_attention_kernel_matches_plain(card, B, H, Hkv, S, T, hd, causal, dtype):
    q = _randn(card, B, H, S, hd, dtype=dtype, mul=0.5)
    k = _randn(card, B, Hkv, T, hd, dtype=dtype, mul=0.5, seed=1)
    v = _randn(card, B, Hkv, T, hd, dtype=dtype, seed=2)
    before = KERNELS["flash_attention"].launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert KERNELS["flash_attention"].launches == before + 1
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, causal=causal).float(),
                               **FLASH_TOL[dtype])


def test_flash_attention_causal_needs_equal_lengths(card):
    q = torch.zeros(1, 2, 8, 64, device=card)
    kv = torch.zeros(1, 2, 16, 64, device=card)
    with pytest.raises(ValueError, match="S == T"):
        flash_attention(q, kv, kv, causal=True)


def test_flash_attention_bf16_needs_aligned_inputs(card):
    """bf16 tiles are copied 16 bytes at a time: an unaligned view raises,
    and is never copied silently."""
    n = 2 * 2 * 64 * 64
    q = _randn(card, n + 1, dtype=torch.bfloat16)[1:].view(2, 2, 64, 64)
    kv = _randn(card, 2, 2, 64, 64, dtype=torch.bfloat16, seed=1)
    before = KERNELS["flash_attention"].launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, kv, kv, causal=True)
    assert KERNELS["flash_attention"].launches == before
    # f32 loads element by element and takes the same view
    q32 = _randn(card, n + 1, dtype=torch.float32)[1:].view(2, 2, 64, 64)
    kv32 = kv.float()
    torch.testing.assert_close(flash_attention(q32, kv32, kv32, causal=True),
                               ref.flash_attention(q32, kv32, kv32, causal=True),
                               **FLASH_TOL[torch.float32])


def test_decode_with_mask_launches_no_kernel(card):
    q = torch.zeros(2, 4, 1, 64, device=card)
    kv = torch.zeros(2, 2, 32, 64, device=card)
    mask = torch.ones(2, 32, dtype=torch.bool, device=card)
    before = KERNELS["flash_attention"].launches
    ops.flash_attention(q, kv, kv, causal=False, kv_mask=mask)
    assert KERNELS["flash_attention"].launches == before


def _wkv6_inputs(card, B, H, S, hd, dtype):
    """r, k, v, the decay by the model's formula (near 1), u and a non-zero
    initial state."""
    r = _randn(card, B, H, S, hd, dtype=dtype, mul=0.5)
    k = _randn(card, B, H, S, hd, dtype=dtype, mul=0.5, seed=1)
    v = _randn(card, B, H, S, hd, dtype=dtype, seed=2)
    w_log = _randn(card, B, H, S, hd, dtype=torch.float32, mul=0.5, add=-6.0, seed=3)
    w = torch.exp(-torch.exp(w_log)).to(dtype)
    u = _randn(card, H, hd, dtype=torch.float32, mul=0.1, seed=4)
    s0 = _randn(card, B, H, hd, hd, dtype=torch.float32, seed=5)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,hd", [(4, 64, 200, 64), (4, 64, 1, 64), (1, 4, 37, 16),
                                      (2, 2, 300, 32),
                                      # ragged staged chunks at rwkv6-7b's widths
                                      (4, 64, 37, 64), (4, 64, 65, 64)])
def test_wkv6_kernel_matches_plain(card, B, H, S, hd, dtype):
    args = _wkv6_inputs(card, B, H, S, hd, dtype)
    before = KERNELS["wkv6"].launches
    y, s = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert KERNELS["wkv6"].launches == before + 1
    y_ref, s_ref = ref.rwkv6_scan(*args)
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), **WKV6_TOL[dtype])
    torch.testing.assert_close(s, s_ref, **WKV6_STATE_TOL[dtype])


def test_wkv6_kernel_unaligned_and_zero_state(card):
    B, H, S, hd = 1, 2, 45, 64
    n = B * H * S * hd

    def odd(seed):  # contiguous, one element past a 16-byte boundary
        return _randn(card, n + 1, dtype=torch.bfloat16, mul=0.5, seed=seed)[1:].view(B, H, S, hd)

    r, k, v = odd(0), odd(1), odd(2)
    w = torch.full((B, H, S, hd), 0.99, dtype=torch.bfloat16, device=card)
    u = _randn(card, H, hd, dtype=torch.float32, mul=0.1, seed=4)
    y, s = ops.rwkv6_scan(r, k, v, w, u)
    y_ref, s_ref = ref.rwkv6_scan(r, k, v, w, u)
    torch.testing.assert_close(y.float(), y_ref.float(), **WKV6_TOL[torch.bfloat16])
    torch.testing.assert_close(s, s_ref, **WKV6_STATE_TOL[torch.bfloat16])


#: the SSD kernel against its plain version: tests/test_kernels.py's f32
#: tolerance for y and the state.  From bf16 x, B and C both sides widen
#: the same values to f32 and run the same f32 recurrence, so it holds too.
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


def _ssd_inputs(card, B, S, H, P, N, dtype, offset=0):
    """x, B and C as the model hands them in: views of one (B, S, H*P + 2N)
    buffer in ``dtype`` (``offset`` elements into it); dt = softplus of a
    normal draw as the model makes it (dt_bias 0), decay = exp(-dt); a
    non-zero f32 initial state."""
    ch = H * P + 2 * N
    buf = _randn(card, B, S, ch + offset, dtype=dtype, mul=0.5)[..., offset:]
    x = buf[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = buf[..., H * P:H * P + N], buf[..., H * P + N:]
    dt = torch.nn.functional.softplus(_randn(card, B, S, H, dtype=torch.float32, seed=1))
    s0 = _randn(card, B, H, P, N, dtype=torch.float32, seed=2)
    return x, Bm, Cm, torch.exp(-dt), dt, s0


def _expected_route(S, P, N, dtype):
    """The source's rule: decode at S 1; chunked for bf16 with P and N
    multiples of 16; sequential otherwise."""
    if S == 1:
        return "decode"
    if dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0:
        return "chunked"
    return "sequential"


def _check_ssd(args, dtype):
    """One launch against the sequential plain version and, on the chunked
    route, against the plain version of the chunk form too."""
    x, Bm = args[0], args[1]
    S, P, N = x.shape[1], x.shape[3], Bm.shape[-1]
    assert route(S, P, N, dtype) == _expected_route(S, P, N, dtype)
    before = KERNELS["mamba2_ssd"].launches
    y, s = mamba2_ssd_scan(*args)
    torch.cuda.synchronize()
    assert KERNELS["mamba2_ssd"].launches == before + 1
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    refs = [ref.mamba2_ssd_scan]
    if route(S, P, N, dtype) == "chunked":
        refs.append(ref.mamba2_ssd_scan_chunked)
    for plain in refs:
        y_ref, s_ref = plain(*args)
        torch.testing.assert_close(y, y_ref, **SSD_TOL)
        torch.testing.assert_close(s, s_ref, **SSD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N", [(4, 200, 80, 64, 64), (4, 1, 80, 64, 64),
                                       (1, 37, 4, 16, 8), (2, 300, 3, 32, 32),
                                       (2, 64, 2, 8, 16),
                                       # zamba2's widths either side of 32-step chunk ends
                                       (4, 63, 80, 64, 64), (4, 64, 80, 64, 64),
                                       (4, 65, 80, 64, 64), (4, 129, 80, 64, 64),
                                       # the chunked route's other tile counts
                                       (2, 70, 3, 16, 16), (1, 100, 2, 128, 64),
                                       (2, 1, 3, 8, 8)])
def test_mamba2_ssd_kernel_matches_plain(card, B, S, H, P, N, dtype):
    _check_ssd(_ssd_inputs(card, B, S, H, P, N, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 65, 200])
def test_mamba2_ssd_kernel_exact_zero_and_unit_decays(card, S, dtype):
    """A decay of exactly 0 (the state is forgotten) at one step and of
    exactly 1 over ten: the chunked route's running products give 0 and 1,
    never 0/0."""
    x, Bm, Cm, dc, dt, s0 = _ssd_inputs(card, 4, S, 80, 64, 64, dtype)
    dc = dc.clone()
    dc[:, S // 3] = 0.0
    dc[:, S // 2:S // 2 + 10] = 1.0
    _check_ssd((x, Bm, Cm, dc, dt, s0), dtype)


def test_mamba2_ssd_kernel_unaligned_and_zero_state(card):
    x, Bm, Cm, dc, dt, _ = _ssd_inputs(card, 2, 45, 8, 64, 64, torch.bfloat16, offset=1)
    y, s = ops.mamba2_ssd_scan(x, Bm, Cm, dc, dt)
    y_ref, s_ref = ref.mamba2_ssd_scan(x, Bm, Cm, dc, dt)
    torch.testing.assert_close(y, y_ref, **SSD_TOL)
    torch.testing.assert_close(s, s_ref, **SSD_TOL)
    # the same odd view at decode, and a state one float past 16 bytes
    x, Bm, Cm, dc, dt, s0 = _ssd_inputs(card, 2, 1, 8, 64, 64, torch.bfloat16, offset=1)
    s0 = torch.cat([s0.new_zeros(1), s0.flatten()])[1:].view_as(s0)
    _check_ssd((x, Bm, Cm, dc, dt, s0), torch.bfloat16)


def _grad_case(card, name, dtype):
    """(wrapper, plain, args) at small shapes; float inputs require grad."""
    def rg(t):
        return t.requires_grad_(True)

    if name == "rmsnorm":
        return rmsnorm, ref.rmsnorm, [rg(_randn(card, 6, 2048, dtype=dtype)),
                                      rg(_randn(card, 2048, dtype=dtype, mul=0.1, add=1.0,
                                                seed=1))]
    if name == "swiglu":
        return swiglu, ref.swiglu, [rg(_randn(card, 6, 512, dtype=dtype)),
                                    rg(_randn(card, 6, 512, dtype=dtype, seed=1))]
    if name == "flash_attention":
        return flash_attention, ref.flash_attention, [
            rg(_randn(card, 2, 8, 71, 64, dtype=dtype, mul=0.5)),
            rg(_randn(card, 2, 2, 71, 64, dtype=dtype, mul=0.5, seed=1)),
            rg(_randn(card, 2, 2, 71, 64, dtype=dtype, seed=2))]
    if name == "wkv6":
        return rwkv6_scan, ref.rwkv6_scan, [rg(t) for t in
                                            _wkv6_inputs(card, 1, 2, 37, 64, dtype)]
    x, Bm, Cm, dc, dt, s0 = _ssd_inputs(card, 2, 37, 4, 64, 64, dtype)
    return mamba2_ssd_scan, ref.mamba2_ssd_scan, [
        rg(x.detach().clone()), rg(Bm.detach().clone()), rg(Cm.detach().clone()), rg(dc),
        rg(dt), rg(s0)]


#: gradients are the plain version's vjp on both sides: the forward
#: tolerances hold them
GRAD_TOL = {"rmsnorm": TOL, "swiglu": TOL, "flash_attention": FLASH_TOL, "wkv6": WKV6_TOL,
            "mamba2_ssd": {torch.float32: SSD_TOL, torch.bfloat16: SSD_TOL}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradients_at_head_dim_96(card, causal, dtype):
    """phi-3-vision's head dim under grad mode: the kernel forward, the
    plain version's vjp backward."""
    args = [_randn(card, 1, 4, 71, 96, dtype=dtype, mul=0.5).requires_grad_(True),
            _randn(card, 1, 4, 71, 96, dtype=dtype, mul=0.5, seed=1).requires_grad_(True),
            _randn(card, 1, 4, 71, 96, dtype=dtype, seed=2).requires_grad_(True)]
    before = KERNELS["flash_attention"].launches
    out = flash_attention(*args, causal=causal)
    assert KERNELS["flash_attention"].launches == before + 1 and out.grad_fn is not None
    cot = _randn(card, *out.shape, dtype=dtype, seed=9)
    grads = torch.autograd.grad(out, args, cot)
    want = torch.autograd.grad(ref.flash_attention(*args, causal=causal), args, cot)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["rmsnorm", "swiglu", "flash_attention", "wkv6",
                                  "mamba2_ssd"])
def test_kernel_gradients_match_plain(card, name, dtype):
    wrapper, plain, args = _grad_case(card, name, dtype)
    before = KERNELS[name].launches
    got = wrapper(*args)
    outs = got if isinstance(got, tuple) else (got,)
    assert KERNELS[name].launches == before + 1
    assert all(o.grad_fn is not None for o in outs)
    cots = [_randn(card, *o.shape, dtype=o.dtype, seed=9 + i) for i, o in enumerate(outs)]
    grads = torch.autograd.grad(outs, args, cots)
    assert KERNELS[name].launches == before + 1  # the backward launches nothing
    want_out = plain(*args)
    want = torch.autograd.grad(want_out if isinstance(want_out, tuple) else (want_out,),
                               args, cots)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w.float(), **GRAD_TOL[name][dtype])
