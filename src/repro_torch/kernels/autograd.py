"""Gradients through the hand-written kernels: kernel forward, plain backward.

The counterpart of the reference's ``_ref_vjp`` (``repro/kernels/ops.py``):
the forward is the kernel launch, and the backward re-runs the kernel's
plain PyTorch version under ``torch.enable_grad()`` and returns its vector-
Jacobian product.  No kernel of the port has a backward of its own, as no
Pallas kernel of the reference has one.

A wrapper hands :func:`kernel_call` its launch function and its plain
version, both taking the same positional arguments.  Where grad mode is off
(the serving path runs under ``torch.no_grad()``) or no tensor argument
requires grad, :func:`kernel_call` is the launch itself: the autograd
function is not entered and the call costs no extra host work.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["KernelVjp", "kernel_call"]


class KernelVjp(torch.autograd.Function):
    """``launch(*args)`` forward; the vjp of ``plain(*args)`` backward.

    ``args`` may mix tensors, ``None`` (an absent state) and plain values
    (eps, flags); the output may be a tensor or a tuple of tensors."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, *args):
        is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.save_for_backward(*(a if t else None for a, t in zip(args, is_tensor)))
        ctx.plain = plain
        ctx.consts = [None if t else a for a, t in zip(args, is_tensor)]
        return launch(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [c if s is None else s.detach().requires_grad_(w)
                    for s, c, w in zip(saved, ctx.consts, wants)]
            out = ctx.plain(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        inputs = [a for a, w in zip(args, wants) if w]
        got = iter(torch.autograd.grad([o for o, _ in pairs], inputs,
                                       [g for _, g in pairs], allow_unused=True)
                   if pairs and inputs else [None] * len(inputs))
        return (None, None) + tuple(next(got) if w else None for w in wants)


def kernel_call(launch: Callable, plain: Callable, *args):
    """``launch(*args)``, differentiable through ``plain``'s vjp when grad
    mode is on and some tensor argument requires grad; each call launches
    the kernel once."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return KernelVjp.apply(launch, plain, *args)
    return launch(*args)
