"""The kernels on DTensors: each wrapper's placement rule, and its call on
this rank's shard.

DTensor has no sharding rule for a call into a hand-written kernel, so a
wrapper handed a DTensor runs itself on the local shards, as
``torch.distributed.tensor.experimental.local_map`` does: the inputs are
redistributed to the placements the kernel's rule accepts (a placement no
rule covers becomes ``Replicate()``, in the open, through
``DTensor.redistribute``), the wrapper runs on ``to_local()`` (so on the
card the kernel launches and its launch counter moves; on the CPU the plain
version runs), and each output becomes a DTensor again.  Unlike
``local_map``, the outputs get their global shapes, so an uneven split (a
batch of 3 rows over 2 ranks) comes back whole.  Gradients go through the
wrapper's own vjp on the local shard; an input that is replicated where the
lead input is sharded (a norm's scale against sharded rows) gets a
``Partial`` gradient there.

The rules, per mesh dim, read from the lead input:

* ``rmsnorm(x, scale)``: any ``Shard`` of x but its last dim; scale
  replicated;
* ``swiglu(gate, up)``: any ``Shard``; up takes gate's placements;
* ``flash_attention(q, k, v)``: batch (dim 0), or heads (dim 1) where the
  mesh dims that split the heads divide ``Hkv``, so that each GQA group's
  query heads stay with their key/value head; k and v follow q;
* ``rwkv6_scan(r, k, v, w, u, state)``: batch (0) or heads (1); u is split
  with the heads; the state follows r;
* ``mamba2_ssd_scan(x, B, C, decay, dt, state)``: batch (0) or heads (2);
  B and C (shared by the heads) follow the batch only; decay, dt and the
  state follow x.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..tree import is_dtensor

__all__ = ["contiguous_stride", "split_of", "rmsnorm_rule", "swiglu_rule", "flash_rule",
           "wkv6_rule", "ssd_rule", "call_local"]


def _lead(x, dims: Sequence[int]) -> List:
    """x's placements with every ``Shard`` outside ``dims`` and every
    ``Partial`` made ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    nd = x.dim()
    return [Shard(p.dim % nd) if isinstance(p, Shard) and p.dim % nd in dims else Replicate()
            for p in x.placements]


def _map(pl: Sequence, table: dict, other=None) -> List:
    """Per mesh dim: ``table[d]`` where ``pl`` is ``Shard(d)``, else
    ``other`` (default ``Replicate()``)."""
    from torch.distributed.tensor import Replicate, Shard

    other = Replicate() if other is None else other
    return [table[p.dim] if isinstance(p, Shard) and p.dim in table else other for p in pl]


def split_of(x, pl: Sequence, dim: int) -> int:
    """How many ways the mesh dims of ``pl`` (placements over ``x``'s mesh)
    that shard ``dim`` split it."""
    from torch.distributed.tensor import Shard

    sizes = x.device_mesh.shape
    return math.prod(n for p, n in zip(pl, sizes) if isinstance(p, Shard) and p.dim == dim)


Rule = Tuple[List, List, List]  # in placements, gradient placements, out placements


def rmsnorm_rule(x, scale) -> Rule:
    from torch.distributed.tensor import Partial, Shard

    pl = _lead(x, range(x.dim() - 1))
    scale_in = _map(pl, {})
    scale_grad = [Partial() if isinstance(p, Shard) else q for p, q in zip(pl, scale_in)]
    return [pl, scale_in], [pl, scale_grad], [pl]


def swiglu_rule(gate, up) -> Rule:
    pl = _lead(gate, range(gate.dim()))
    return [pl, pl], [pl, pl], [pl]


def flash_rule(q, k, v) -> Rule:
    from torch.distributed.tensor import Replicate, Shard

    pl = _lead(q, (0, 1))
    if k.shape[1] % split_of(q, pl, 1):  # a GQA group would be cut
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl]
    return [pl, pl, pl], [pl, pl, pl], [pl]


def wkv6_rule(r, k, v, w, u, state) -> Rule:
    from torch.distributed.tensor import Partial, Shard

    pl = _lead(r, (0, 1))
    u_in = _map(pl, {1: Shard(0)})
    u_grad = _map(pl, {0: Partial(), 1: Shard(0)})
    st = None if state is None else pl
    return [pl, pl, pl, pl, u_in, st], [pl, pl, pl, pl, u_grad, st], [pl, pl]


def ssd_rule(x, Bmat, Cmat, decay, dt, state) -> Rule:
    from torch.distributed.tensor import Partial, Shard

    pl = _lead(x, (0, 2))
    bc_in = _map(pl, {0: Shard(0)})
    bc_grad = _map(pl, {0: Shard(0), 2: Partial()})
    st = _map(pl, {0: Shard(0), 2: Shard(1)})
    st_in = None if state is None else st
    return ([pl, bc_in, bc_in, pl, pl, st_in], [pl, bc_grad, bc_grad, pl, pl, st_in],
            [pl, st])


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: the vjp of a
    plain version may return a strided gradient, while ``to_local``'s
    backward gives it the contiguous strides of the forward input, and a
    later ``view`` of the DTensor would fail on the mismatch."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def call_local(fn: Callable, rule: Callable, args: Sequence, out_shapes: Sequence,
               name: str):
    """``fn`` on the local shards of ``args`` (tensors and ``None``) placed
    by ``rule(*args)``; returns a DTensor an output (a tuple when there are
    several) of the global shapes ``out_shapes``.  A plain tensor among
    DTensors is taken as replicated on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = args[0].device_mesh
    placed = []
    for a in args:
        if isinstance(a, torch.Tensor) and not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        placed.append(a)
    in_pl, grad_pl, out_pl = rule(*placed)
    local: List[Optional[torch.Tensor]] = []
    for a, pl, gpl in zip(placed, in_pl, grad_pl):
        if a is None:
            local.append(None)
            continue
        if a.device_mesh != mesh:
            raise ValueError(f"{name}: inputs on different meshes")
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        t = a.to_local(grad_placements=gpl)
        local.append(_ContiguousGrad.apply(t) if t.requires_grad else t)
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(
        DTensor.from_local(o.contiguous(), mesh, pl, run_check=False, shape=torch.Size(shape),
                           stride=contiguous_stride(shape))
        for o, pl, shape in zip(outs, out_pl, out_shapes))
    return wrapped if isinstance(out, tuple) else wrapped[0]
