"""Mesh helpers: factorized axes are how OpTree's m-ary tree lands on a world
of processes.

A paper "k-stage m-ary tree over N ring nodes" becomes a logical axis of size
N split into named sub-axes (m_1, ..., m_k), *major first*: rank ``r`` of the
``torch.distributed`` world sits at coordinates
``np.unravel_index(r, (m_1, ..., m_k))``, the row-major order that
``jax.make_mesh`` gives the reference's devices.  Stage j of the paper
(subsets = "same position across the m_j siblings") is a collective within
the process group of sub-axis j.

The reference runs one program over all devices inside ``shard_map`` and
asks the ambient axis env for ``lax.axis_index(name)`` and the axis size.
Here every rank runs its own copy, and a :class:`FactorizedMesh` answers
both questions from its coordinates.  Every process group the executors use
is built once, in ``FactorizedMesh.__init__``, in the same order on every
rank: ``dist.new_group`` hangs the world when ranks create groups in
different orders, so no op ever creates one.
"""
from __future__ import annotations

import itertools
import math
import os
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["FactorizedMesh", "AxisGroup", "check_world_device", "init_world",
           "make_factorized_mesh", "resolve_mesh"]

#: rendezvous and collective timeout of :func:`init_world`: a world whose
#: ranks never meet fails in a minute instead of hanging
DEFAULT_TIMEOUT = timedelta(seconds=60)


def check_world_device(device: Union[str, torch.device], world_size: int) -> torch.device:
    """Raise unless a world of ``world_size`` ranks can run on ``device``: a
    CUDA world needs a card per rank (NCCL refuses two ranks on one GPU),
    and nothing falls back to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the collectives run on a CUDA device by default and none is "
                "available; pass device='cpu' for a gloo world on the host")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise RuntimeError(
                f"a CUDA world of {world_size} ranks needs {world_size} cards "
                f"(NCCL holds one rank per GPU) and this host has {cards}; "
                f"pass device='cpu' for a gloo world on the host")
    elif dev.type != "cpu":
        raise ValueError(f"the collectives run on cuda or cpu, got {dev}")
    return dev


def init_world(
    device: Union[str, torch.device] = "cuda",
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    store_path: Optional[str] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join a ``torch.distributed`` world and return this rank's device.

    The backend follows the device: NCCL for ``cuda`` (the default), gloo
    for ``cpu``.  A CUDA world needs one card per rank (NCCL refuses two
    ranks on one GPU), so a world larger than ``torch.cuda.device_count()``
    raises; nothing falls back to the CPU by itself.  The rendezvous is
    ``env://`` when ``torchrun``'s variables are set, else the ``FileStore``
    at ``store_path`` (a fresh file that every rank of the world names).
    """
    dev = torch.device(device)
    env = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    check_world_device(dev, world_size)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if env:
        dist.init_process_group(backend, init_method="env://", timeout=timeout,
                                world_size=world_size, rank=rank)
    else:
        if store_path is None:
            raise ValueError(
                "init_world needs store_path (a FileStore file) when "
                "torchrun's RANK, WORLD_SIZE and MASTER_ADDR are not set")
        store = dist.FileStore(str(store_path), world_size)
        dist.init_process_group(backend, store=store, timeout=timeout,
                                world_size=world_size, rank=rank)
    return dev


class AxisGroup:
    """One process group over a tuple of mesh axes, as this rank sees it.

    ``ranks[i]`` is the global rank of the member whose coordinates on the
    tuple linearize (row-major, in the tuple's order) to ``i``; ``index`` is
    this rank's own ``i``.  ``dist.new_group`` numbers its members by sorted
    global rank, which is the tuple order exactly when the tuple is in mesh
    order; otherwise ``to_group`` maps tuple index to group rank (and
    ``from_group`` back), and the mesh's collectives permute blocks through
    them.
    """

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.index = int(index)
        self.size = len(self.ranks)
        # group rank of tuple index i, and tuple index of group rank g
        to_group = np.argsort(np.argsort(self.ranks))
        identity = bool((to_group == np.arange(self.size)).all())
        self.to_group = None if identity else torch.as_tensor(to_group)
        self.from_group = None if identity else torch.as_tensor(np.argsort(to_group))


class FactorizedMesh:
    """The reference's factorized ``jax.sharding.Mesh`` as a process world.

    ``shape`` maps each axis name to its size, as ``Mesh.shape`` does.  The
    mesh covers ranks ``0 .. prod(factors) - 1`` of the current world and
    builds one process group for every non-empty tuple of its axes (each
    axis alone, every one-shot stage's tuple, the whole mesh), in a fixed
    order, at construction.  Every rank of the world must construct the same
    meshes in the same order.
    """

    def __init__(self, factors: Sequence[int], names: Sequence[str]):
        if len(factors) != len(names):
            raise ValueError("factors and names must align")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names must be distinct, got {tuple(names)}")
        if not dist.is_initialized():
            raise RuntimeError(
                "FactorizedMesh needs a torch.distributed world; call "
                "init_world first")
        self.factors = tuple(int(f) for f in factors)
        self.axis_names = tuple(names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.factors))
        self.size = math.prod(self.factors)
        world = dist.get_world_size()
        if self.size > world:
            raise ValueError(f"need {self.size} ranks, have {world}")
        self.rank = dist.get_rank()
        self.member = self.rank < self.size
        grid = np.arange(self.size).reshape(self.factors)
        coords = (np.unravel_index(self.rank, self.factors) if self.member
                  else (0,) * len(self.factors))
        self.coords: Dict[str, int] = {
            n: int(c) for n, c in zip(self.axis_names, coords)}
        self._groups: Dict[Tuple[int, ...], tuple] = {}
        k = len(self.axis_names)
        for r in range(1, k + 1):
            for dims in itertools.combinations(range(k), r):
                self._groups[dims] = self._build(grid, dims)

    def _build(self, grid: np.ndarray, dims: Tuple[int, ...]):
        """Create every group over ``dims`` (each rank of the world calls
        ``new_group`` for all of them, members or not) and keep this rank's
        own, as (group, global ranks in mesh order)."""
        rest = [d for d in range(grid.ndim) if d not in dims]
        moved = np.transpose(grid, rest + list(dims))
        members = moved.reshape(-1, math.prod(grid.shape[d] for d in dims))
        mine = None
        for ranks in members:
            group = dist.new_group(ranks=[int(r) for r in ranks])
            if self.rank in ranks:
                mine = (group, tuple(int(r) for r in ranks))
        return mine

    # -- the reference's axis env ------------------------------------------
    def axis_size(self, names: Union[str, Sequence[str]]) -> int:
        names = (names,) if isinstance(names, str) else tuple(names)
        return math.prod(self.shape[n] for n in names)

    def axis_index(self, names: Union[str, Sequence[str]]) -> int:
        """This rank's position on ``names``: the coordinate on one axis, or
        the row-major linearization over a tuple in the tuple's order."""
        names = (names,) if isinstance(names, str) else tuple(names)
        idx = 0
        for n in names:
            idx = idx * self.shape[n] + self.coords[n]
        return idx

    def group(self, names: Union[str, Sequence[str]]) -> AxisGroup:
        """The process group over ``names`` that holds this rank."""
        names = (names,) if isinstance(names, str) else tuple(names)
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is outside the mesh {self.shape}")
        unknown = [n for n in names if n not in self.shape]
        if unknown or len(set(names)) != len(names):
            raise ValueError(f"axes {names} are not distinct axes of {self.axis_names}")
        dims = tuple(sorted(self.axis_names.index(n) for n in names))
        group, mesh_ranks = self._groups[dims]
        # mesh_ranks are in mesh order (the dims sorted); reorder them to
        # the tuple's linearization
        sub = [self.factors[d] for d in dims]
        tup = [self.axis_names.index(n) for n in names]
        perm = [dims.index(d) for d in tup]
        ranks = np.asarray(mesh_ranks).reshape(sub).transpose(perm).reshape(-1)
        return AxisGroup(group, ranks, self.axis_index(names))

    # -- the reference's lax collectives, on this rank's local shard -------
    # Each takes blocks in the canonical order of ``names`` (major first),
    # as the reference's tiled collectives over an axis tuple do.

    def all_gather(self, x: torch.Tensor, names) -> torch.Tensor:
        """``lax.all_gather(x, names, axis=0, tiled=False)``: the members'
        ``x`` stacked on a new leading axis, in tuple order."""
        g = self.group(names)
        flat = x.reshape(-1).contiguous()  # gloo checks the 1-D sizes
        out = torch.empty(g.size * flat.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, flat, group=g.group)
        out = out.view((g.size,) + tuple(x.shape))
        if g.to_group is not None:
            out = out.index_select(0, g.to_group.to(out.device))
        return out

    def psum_scatter(self, y: torch.Tensor, names) -> torch.Tensor:
        """``lax.psum_scatter(y, names, scatter_dimension=0, tiled=True)``:
        block ``axis_index(names)`` of the members' sum."""
        g = self.group(names)
        if y.shape[0] % g.size:
            raise ValueError(f"length {y.shape[0]} not divisible by group size {g.size}")
        blk = y.shape[0] // g.size
        if g.to_group is not None:
            y = y.reshape((g.size, blk) + tuple(y.shape[1:]))
            y = y.index_select(0, g.from_group.to(y.device)).reshape(
                (g.size * blk,) + tuple(y.shape[2:]))
        flat = y.reshape(-1).contiguous()
        out = torch.empty(flat.numel() // g.size, dtype=y.dtype, device=y.device)
        dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=g.group)
        return out.view((blk,) + tuple(y.shape[1:]))

    def psum(self, y: torch.Tensor, names) -> torch.Tensor:
        """``lax.psum(y, names)``."""
        g = self.group(names)
        out = y.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g.group)
        return out

    def pmax(self, y: torch.Tensor, names) -> torch.Tensor:
        """``lax.pmax(y, names)``: the members' elementwise maximum."""
        g = self.group(names)
        out = y.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g.group)
        return out

    def all_to_all(self, y: torch.Tensor, names, dim: int = 0) -> torch.Tensor:
        """``lax.all_to_all(y, names, split_axis=dim, concat_axis=dim,
        tiled=True)``: slice j of ``dim`` goes to member j, and slice j of
        the result came from member j."""
        g = self.group(names)
        if y.shape[dim] % g.size:
            raise ValueError(f"dim {dim} of {tuple(y.shape)} not divisible by {g.size}")
        x = torch.movedim(y, dim, 0)
        shape = tuple(x.shape)
        blocks = x.reshape((g.size, -1))
        if g.to_group is not None:
            blocks = blocks.index_select(0, g.from_group.to(x.device))
        flat = blocks.reshape(-1).contiguous()
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, group=g.group)
        out = out.view(blocks.shape)
        if g.to_group is not None:
            out = out.index_select(0, g.to_group.to(x.device))
        return torch.movedim(out.reshape(shape), 0, dim)

    def ppermute(self, x: torch.Tensor, name, dst: int, src: int) -> torch.Tensor:
        """One ``lax.ppermute`` hop seen from this rank: send ``x`` to the
        member at index ``dst`` on ``name`` and return what the member at
        ``src`` sent (one ``batch_isend_irecv`` within the axis group; the
        peers are global ranks)."""
        g = self.group(name)
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, g.ranks[dst], g.group),
               dist.P2POp(dist.irecv, out, g.ranks[src], g.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def __repr__(self) -> str:
        return f"FactorizedMesh({self.shape}, rank={self.rank})"


def make_factorized_mesh(factors: Sequence[int], names: Sequence[str]) -> FactorizedMesh:
    """The reference's entry name: the mesh whose axes are the stage factors
    of one logical OpTree axis, over the current world."""
    return FactorizedMesh(factors, names)


def resolve_mesh(mesh: Optional[FactorizedMesh]) -> FactorizedMesh:
    """The mesh an executor runs on: the one passed, else the mesh of the
    innermost installed :class:`~repro_torch.comms.api.CommContext` (the
    port's counterpart of the reference's ambient shard_map axis env)."""
    if mesh is not None:
        return mesh
    from .api import current_context  # lazy: api imports the executors

    ctx = current_context(None)
    if ctx is None or ctx.mesh is None:
        raise ValueError(
            "no mesh: pass mesh=... or install one with "
            "comm_context(mesh, axis_names)")
    return ctx.mesh
