"""The process mesh: the port's counterpart of a JAX device mesh.

The reference runs one SPMD program under ``shard_map`` over a
``jax.sharding.Mesh`` (``runtime/compat.make_mesh``) and names its
collectives by mesh axis (``jax.lax.psum``, ``all_gather``,
``axis_index``). The port runs one process per rank on
``torch.distributed``, as ``torchrun`` starts them, and ``ProcessMesh``
lays those ranks out on the same grid: rank r takes the row-major
coordinates that ``jax.make_mesh`` gives device r.

At construction every rank creates, in one loop and in the same order,
one process group per slice along the data axes (``batch_axes``) and
one per slice along ``model``, as ``torch.distributed.new_group``
requires even of the ranks outside a group. The collectives then take
the reference's names:

* ``psum(x, axes)``: an in-place ``all_reduce(SUM)`` over the slice of
  ``axes`` that holds this rank (all axes: the whole world);
* ``all_gather(x, axis)``: an all-reduce of a zero-filled ``(P, ...)``
  buffer with this rank's slot written, exact for integers and floats
  alike, since adding 0 changes no value;
* ``axis_index(axis)``: this rank's coordinate.

Every collective is an ``all_reduce`` or a ``barrier``, which NCCL, gloo
on CPU tensors and gloo on CUDA tensors all take, so one code path serves
the three. ``batch_axes`` and ``mesh_axis_size`` are the reference's
(``src/repro/runtime/sharding.py``), over a ``ProcessMesh``.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ProcessMesh", "batch_axes", "mesh_axis_size"]


def mesh_axis_size(mesh, axes: str | Sequence[str] | None) -> int:
    """Product of the extents of ``axes`` (1 for None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def batch_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: ('pod','data') on multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


class ProcessMesh:
    """The ranks of the default process group on a named grid.

    ``shape`` is a dict of axis extents in axis order, as ``Mesh.shape``;
    ``coords`` this rank's coordinate on each axis; ``ranks`` the grid of
    global ranks (``Mesh.devices``' counterpart). The default group must
    be initialized, and the grid must hold exactly its world size.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(e) for e in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "must pair one extent with each distinct name")
        if any(e < 1 for e in shape):
            raise ValueError(f"mesh shape {shape}: every extent must be >= 1")
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "ProcessMesh needs an initialized default process group: "
                "call torch.distributed.init_process_group first (torchrun "
                "sets its environment), e.g. with backend 'nccl' on the "
                "card or 'gloo' on the CPU")
        world = dist.get_world_size()
        need = int(np.prod(shape))
        if need != world:
            raise ValueError(
                f"mesh {dict(zip(names, shape))} holds {need} ranks but the "
                f"default process group has world size {world}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.ranks = np.arange(world).reshape(shape)
        self.coords = {a: int(c) for a, c in
                       zip(names, np.unravel_index(self.rank, shape))}
        self._groups: dict[frozenset, object] = {}
        for axes in (batch_axes(self), ("model",)):
            axes = tuple(a for a in axes if a in self.shape)
            if axes and set(axes) != set(names):
                self._groups[frozenset(axes)] = self._slice_group(axes)

    def _slice_group(self, axes: tuple[str, ...]):
        """One ``new_group`` per slice along ``axes`` (every rank makes
        every group, in the same order); returns this rank's."""
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        move = [i for i, a in enumerate(self.axis_names) if a in axes]
        grid = self.ranks.transpose(keep + move)
        mine = None
        for idx in itertools.product(*(range(grid.shape[i])
                                       for i in range(len(keep)))):
            members = [int(r) for r in grid[idx].ravel()]
            group = dist.new_group(members)
            if self.rank in members:
                mine = group
        return mine

    def _group(self, axes: str | Sequence[str]):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = frozenset(axes)
        if key == frozenset(self.axis_names):
            return None                                  # the whole world
        if key not in self._groups:
            raise ValueError(
                f"no process group for axes {axes}: this mesh reduces over "
                f"{[tuple(sorted(k)) for k in self._groups]} or all of "
                f"{self.axis_names}")
        return self._groups[key]

    # -- the reference's collectives ------------------------------------------

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def psum(self, x: torch.Tensor, axes: str | Sequence[str]
             ) -> torch.Tensor:
        """Σ of ``x`` over the ranks of this rank's slice along ``axes``,
        IN PLACE (``x`` is the result)."""
        if isinstance(axes, str) or len(tuple(axes)):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self._group(axes))
        return x

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(P, *x.shape): slot p holds the ``x`` of the rank at coordinate
        p along ``axis`` (an all-reduce of a zero buffer, exact)."""
        out = torch.zeros((self.shape[axis],) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
        out[self.axis_index(axis)] = x
        return self.psum(out, axis)

    def barrier(self) -> None:
        dist.barrier()

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, backend={self.backend!r})")
