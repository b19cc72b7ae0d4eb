"""Gradients through the port's kernel wrappers, on the CPU.

``repro_torch.kernels.autograd.kernel_call`` is what every wrapper calls
for a CUDA tensor: the kernel launch forward and the plain version's vjp
backward, as the reference's ``_ref_vjp`` (``repro/kernels/ops.py``).  On
the CPU it is driven here with each kernel's plain version standing in for
the launch, on inputs drawn with numpy from a fixed seed:

* the output carries the helper's ``grad_fn``, and its gradients equal the
  plain version's own autograd within 1e-6;
* they equal ``jax.vjp`` of the reference's oracle (what ``_ref_vjp``'s
  backward computes) within the forward tolerances of
  ``tests/test_torch_kernels.py`` (f32 1e-5, flash 2e-4, the scans 1e-4);
* under ``torch.no_grad()``, or with no input requiring grad, the helper
  calls the launch directly and never enters the autograd function;
* the launch runs once per call, the backward included.

The wrappers' kernel path itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``[check/grad]``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import autograd as kgrad
from repro_torch.kernels import ref

#: gradient against jax.vjp of the oracle: the forward tolerances (f32)
JAX_TOL = {"rmsnorm": 1e-5, "swiglu": 1e-5, "flash_attention": 2e-4,
           "flash_attention_full": 2e-4, "rwkv6_scan": 1e-4, "rwkv6_scan_zero_state": 1e-4,
           "mamba2_ssd_scan": 1e-4, "mamba2_ssd_scan_zero_state": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flash(q, k, v, causal, scale):
    return ref.flash_attention(q, k, v, causal=causal, scale=scale)


def _jflash(q, k, v, causal, scale):
    return jref.flash_attention(q, k, v, causal=causal, scale=scale)


def _case(name):
    """(plain, jax oracle, args): positional args of both, float arrays as
    numpy f32, other values as they are; None is an absent state."""
    rng = np.random.default_rng(7)

    def normal(*shape, mul=1.0, add=0.0):
        return (rng.normal(size=shape) * mul + add).astype(np.float32)

    if name == "rmsnorm":
        return ref.rmsnorm, jref.rmsnorm, [normal(3, 5, 16), normal(16, mul=0.1, add=1.0), 1e-5]
    if name == "swiglu":
        return ref.swiglu, jref.swiglu, [normal(4, 24), normal(4, 24)]
    if name.startswith("flash_attention"):
        causal = name == "flash_attention"
        S, T = (9, 9) if causal else (7, 12)
        return _flash, _jflash, [normal(2, 4, S, 16, mul=0.5), normal(2, 2, T, 16, mul=0.5),
                                 normal(2, 2, T, 16), causal, None]
    if name.startswith("rwkv6_scan"):
        B, H, S, hd = 1, 2, 6, 16
        w = np.exp(-np.exp(normal(B, H, S, hd, mul=0.5, add=-1.0)))
        state = None if name.endswith("zero_state") else normal(B, H, hd, hd)
        return ref.rwkv6_scan, jref.rwkv6_scan, [
            normal(B, H, S, hd, mul=0.5), normal(B, H, S, hd, mul=0.5), normal(B, H, S, hd),
            w, normal(H, hd, mul=0.1), state]
    if name.startswith("mamba2_ssd_scan"):
        B, S, H, P, N = 2, 6, 3, 8, 16
        dt = np.log1p(np.exp(normal(B, S, H)))
        state = None if name.endswith("zero_state") else normal(B, H, P, N)
        return ref.mamba2_ssd_scan, jref.mamba2_ssd_scan, [
            normal(B, S, H, P, mul=0.5), normal(B, S, N, mul=0.5), normal(B, S, N, mul=0.5),
            np.exp(-dt), dt, state]
    raise KeyError(name)


CASES = list(JAX_TOL)


def _torch_args(args, requires_grad=True):
    return [torch.from_numpy(a).requires_grad_(requires_grad) if isinstance(a, np.ndarray)
            else a for a in args]


def _cotangents(outs, seed=11):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(np.float32)) for o in outs]


def _grads(outs, cots, args):
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return torch.autograd.grad(outs, tensors, cots)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", CASES)
def test_kernel_call_gradients_equal_the_plain_versions(name):
    plain, _, args = _case(name)
    targs = _torch_args(args)
    outs = _as_tuple(kgrad.kernel_call(plain, plain, *targs))
    assert all(o.grad_fn is not None and "KernelVjp" in o.grad_fn.name() for o in outs)
    cots = _cotangents(outs)
    got = _grads(outs, cots, targs)

    pargs = _torch_args(args)
    want = _grads(_as_tuple(plain(*pargs)), cots, pargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_kernel_call_gradients_match_the_reference_vjp(name):
    plain, oracle, args = _case(name)
    targs = _torch_args(args)
    outs = _as_tuple(kgrad.kernel_call(plain, plain, *targs))
    cots = _cotangents(outs)
    got = _grads(outs, cots, targs)

    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def f(*xs):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return oracle(*full)

    jouts, vjp = jax.vjp(f, *(jnp.asarray(args[i]) for i in arrays))
    jcots = tuple(jnp.asarray(c.numpy()) for c in cots)
    want = vjp(jcots if isinstance(jouts, tuple) else jcots[0])
    tol = JAX_TOL[name]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", CASES)
def test_kernel_call_skips_autograd_without_grad(name, monkeypatch):
    plain, _, args = _case(name)

    def entered(*a):
        raise AssertionError("kernel_call entered the autograd function")

    monkeypatch.setattr(kgrad.KernelVjp, "apply", entered)
    with torch.no_grad():
        outs = _as_tuple(kgrad.kernel_call(plain, plain, *_torch_args(args)))
    assert all(o.grad_fn is None for o in outs)
    outs = _as_tuple(kgrad.kernel_call(plain, plain, *_torch_args(args, requires_grad=False)))
    assert all(o.grad_fn is None for o in outs)
    want = _as_tuple(plain(*_torch_args(args, requires_grad=False)))
    for o, w in zip(outs, want):
        assert torch.equal(o, w)


def test_kernel_call_launches_once_and_backward_runs_the_plain_version():
    plain, _, args = _case("rwkv6_scan")
    calls = {"launch": 0, "plain": 0}

    def launch(*a):
        calls["launch"] += 1
        return plain(*a)

    def counted_plain(*a):
        calls["plain"] += 1
        return plain(*a)

    targs = _torch_args(args)
    y, s = kgrad.kernel_call(launch, counted_plain, *targs)
    assert calls == {"launch": 1, "plain": 0}
    (y.sum() + s.sum()).backward()  # both outputs of the tuple carry the vjp
    assert calls == {"launch": 1, "plain": 1}
    assert all(a.grad is not None for a in targs if isinstance(a, torch.Tensor))


def test_kernel_call_gradient_of_one_output_of_a_tuple():
    """Only y enters the loss: the state's cotangent is zeros."""
    plain, _, args = _case("mamba2_ssd_scan")
    targs = _torch_args(args)
    y, _ = kgrad.kernel_call(plain, plain, *targs)
    got = torch.autograd.grad(y.sum(), [a for a in targs if isinstance(a, torch.Tensor)])
    pargs = _torch_args(args)
    want = torch.autograd.grad(plain(*pargs)[0].sum(),
                               [a for a in pargs if isinstance(a, torch.Tensor)])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
