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
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.swiglu import swiglu

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


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
@pytest.mark.parametrize("shape", [(4, 128), (3, 5, 256), (2, 7, 384), (1, 1, 512), (6, 2048)])
def test_rmsnorm_kernel_matches_plain(card, shape, dtype):
    x = _randn(card, *shape, dtype=dtype)
    scale = _randn(card, shape[-1], dtype=dtype, mul=0.1, add=1.0, seed=1)
    before = KERNELS["rmsnorm"].launches
    got = rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert KERNELS["rmsnorm"].launches == before + 1
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, scale).float(), **TOL[dtype])


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


def test_decode_with_mask_launches_no_kernel(card):
    q = torch.zeros(2, 4, 1, 64, device=card)
    kv = torch.zeros(2, 2, 32, 64, device=card)
    mask = torch.ones(2, 32, dtype=torch.bool, device=card)
    before = KERNELS["flash_attention"].launches
    ops.flash_attention(q, kv, kv, causal=False, kv_mask=mask)
    assert KERNELS["flash_attention"].launches == before
