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
* ``pmin(x, axes)`` and ``pmax(x, axes)``: the same with ``MIN`` (the
  count tripwire's) and ``MAX`` (the flash-decode's running max);
* ``axis_index(axis)``: this rank's coordinate.

Every collective is an ``all_reduce`` or a ``barrier``, which NCCL, gloo
on CPU tensors and gloo on CUDA tensors all take, so one code path serves
the three. With ``voting`` on (a supervised fit sets it), every one of
them is preceded by ``vote``: the rank-agreed faults of
``runtime/fault.py``. A row of zeros from every rank lets the collective
run; a filled row from any rank raises the same ``RankFault`` (or
``RankAbort``) on every rank instead. ``batch_axes`` and ``mesh_axis_size`` are the reference's
(``src/repro/runtime/sharding.py``), over a ``ProcessMesh``.

The sharded LM adds the rest of the reference module:

* ``PartitionSpec`` (a tuple: None, an axis name or an axis tuple per
  dim, entry for entry the reference's ``jax.sharding.PartitionSpec``),
  ``safe_spec``, ``LogicalRules`` with its four policy tables,
  ``use_rules`` and ``current_rules``; ``MeshShape`` is a mesh with axis
  names and extents and no process group, for planning and the rule
  functions, which read only ``.shape``;
* ``constrain`` and ``constrain_alt`` have no port. GSPMD derives the
  reference's collectives from those annotations; eager PyTorch cannot,
  so the sharded model calls its collectives explicitly, Megatron-style,
  through the differentiable functions below (``copy_to``,
  ``reduce_from``, ``gather_along``, ``scatter_along``, ``all_to_all``),
  each an ``autograd.Function`` with its adjoint;
* ``shard_leaf`` and ``gather_leaf`` cut a full tensor to this rank's
  block of a spec and put the blocks back together; ``gather_param`` is
  ``gather_leaf`` whose backward is the reduce-scatter (the gradient
  summed over the spec's axes, then cut to the block): a param stored
  in blocks and gathered on use by ranks that run their own rows (the
  fsdp policy, the serving layout's data-axis blocks).

Every one of them is built on ``ProcessMesh.psum`` (an all-gather is the
sum of zero buffers with one block written, an all-to-all the same over
a ``(P, P, ...)`` buffer), so NCCL, gloo on the CPU and gloo on the card
share one path. Sums run in the tensor's dtype, bfloat16 included, as
NCCL's do (gloo takes bfloat16 on CPU and CUDA tensors alike: torch 2.13
on the CPU, 2.11 on the H100). ``ProcessMesh.traffic`` counts, by kind
of collective, the calls, the bytes handed to ``all_reduce``, and by
group size the calls and the bytes of the collective's result (an
all-to-all's or a reduce-scatter's is its buffer over the group size);
``ring_bytes`` is the reference's ring model over those
(``src/repro/roofline/analysis.py``), what a native collective of that
kind would move.

Sequence parallelism adds ``gather_rs`` (an all-gather whose backward is
the reduce-scatter: the gathered tensor used differently on every rank),
``reduce_scatter_along`` (its adjoint) and ``swap_along`` (one dim's
blocks exchanged for another's: an all-to-all).

``PlanMesh`` is a ``ProcessMesh`` with no process group, for the
planner (``launch/dryrun.py``): one chosen rank's coordinates on the
grid; its collectives return tensors of the right shape (meta tensors
in a plan) and count calls and bytes as a real mesh does; ``vote`` and
``barrier`` do nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime.fault import (FAULT_FATAL, VOTE_NAME_CHARS,
                                       RankAbort, RankFault)

__all__ = ["ProcessMesh", "MeshShape", "PartitionSpec", "batch_axes",
           "mesh_axis_size", "safe_spec", "spec_axes", "LogicalRules",
           "use_rules", "current_rules", "axes_index", "shard_leaf",
           "gather_leaf", "copy_to", "reduce_from", "gather_along",
           "scatter_along", "all_to_all", "gather_param", "gather_rs",
           "reduce_scatter_along", "swap_along", "PlanMesh", "ring_bytes"]


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


def ring_bytes(kind: str, result_bytes: float, group: int) -> float:
    """A rank's wire bytes for one collective of ``kind`` whose result
    holds ``result_bytes``, over a group of ``group`` ranks: the
    reference's ring model (``src/repro/roofline/analysis.py``). Kinds
    are the reference's HLO names or the port's (``all_gather``,
    ``checkpoint`` an all-gather; ``all_reduce``; ``reduce_scatter``;
    ``all_to_all``; ``collective_permute``)."""
    g = max(int(group), 1)
    kind = kind.replace("-", "_")
    if kind in ("all_gather", "checkpoint", "all_to_all"):
        return result_bytes * (g - 1) / g
    if kind == "all_reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "reduce_scatter":
        return result_bytes * (g - 1)
    if kind == "collective_permute":
        return float(result_bytes)
    raise ValueError(f"collective kind {kind!r}: not one the ring model "
                     "knows")


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
        # a supervised fit votes before every collective (``vote``)
        self.voting = False
        self._vote_device = torch.device(
            "cuda", torch.cuda.current_device()) \
            if self.backend == "nccl" else torch.device("cpu")
        # calls and bytes handed to all_reduce, by kind of collective
        self.traffic: dict[str, list[int]] = {}
        self._groups: dict[frozenset, object] = {}
        self.ensure_groups([batch_axes(self), ("model",)])

    def ensure_groups(self, axis_sets) -> None:
        """Make the slice groups of every axis set in ``axis_sets`` that
        has none yet. Collective: every rank calls it with the same sets
        (groups are made in the mesh's axis order, whatever the order
        given)."""
        want = set()
        for axes in axis_sets:
            axes = tuple(a for a in self.axis_names
                         if a in ((axes,) if isinstance(axes, str)
                                  else tuple(axes)))
            if axes and set(axes) != set(self.axis_names):
                want.add(axes)
        for axes in sorted(want, key=lambda t: [self.axis_names.index(a)
                                                for a in t]):
            if frozenset(axes) not in self._groups:
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

    # -- rank-agreed faults ---------------------------------------------------

    def vote(self, row: np.ndarray | None = None) -> np.ndarray:
        """Every rank's vote, ``(world, 1 + VOTE_NAME_CHARS)`` int32: an
        all-reduce over the whole world with this rank's row written
        (zeros: healthy)."""
        t = torch.zeros((self.ranks.size, 1 + VOTE_NAME_CHARS),
                        dtype=torch.int32, device=self._vote_device)
        if row is not None:
            t[self.rank] = torch.from_numpy(np.asarray(row, np.int32))
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t.cpu().numpy()

    def agree(self, row: np.ndarray | None = None) -> None:
        """Vote, and raise the agreed fault when any rank voted one."""
        votes = self.vote(row)
        if votes[:, 0].any():
            if (votes[:, 0] == FAULT_FATAL).any():
                raise RankAbort(votes)
            raise RankFault(votes)

    def _before(self) -> None:
        if self.voting:
            self.agree()

    # -- the reference's collectives ------------------------------------------

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def _axes(self, axes) -> tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def record(self, kind: str, x: torch.Tensor, axes) -> None:
        """Count one collective of ``kind`` on ``x`` (the tensor handed to
        ``all_reduce``) over ``axes`` in ``traffic``: calls and bytes,
        and by group size the calls and the result's bytes."""
        g = mesh_axis_size(self, self._axes(axes))
        nbytes = x.numel() * x.element_size()
        calls = self.traffic.setdefault(kind, [0, 0, {}])
        calls[0] += 1
        calls[1] += nbytes
        by = calls[2].setdefault(g, [0, 0])
        by[0] += 1
        by[1] += nbytes // g if kind in ("all_to_all", "reduce_scatter") \
            else nbytes

    def _all_reduce(self, x: torch.Tensor, axes, op, kind: str
                    ) -> torch.Tensor:
        if isinstance(axes, str) or len(tuple(axes)):
            self.record(kind, x, axes)
            self._before()
            dist.all_reduce(x, op=op, group=self._group(axes))
        return x

    def psum(self, x: torch.Tensor, axes: str | Sequence[str]
             ) -> torch.Tensor:
        """Σ of ``x`` over the ranks of this rank's slice along ``axes``,
        IN PLACE (``x`` is the result)."""
        return self._all_reduce(x, axes, dist.ReduceOp.SUM, "all_reduce")

    def pmin(self, x: torch.Tensor, axes: str | Sequence[str]
             ) -> torch.Tensor:
        """min of ``x`` over the ranks of this rank's slice along ``axes``,
        in place."""
        return self._all_reduce(x, axes, dist.ReduceOp.MIN, "all_reduce")

    def pmax(self, x: torch.Tensor, axes: str | Sequence[str]
             ) -> torch.Tensor:
        """max of ``x`` over the ranks of this rank's slice along ``axes``,
        in place."""
        return self._all_reduce(x, axes, dist.ReduceOp.MAX, "all_reduce")

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(P, *x.shape): slot p holds the ``x`` of the rank at coordinate
        p along ``axis`` (an all-reduce of a zero buffer, exact)."""
        out = torch.zeros((self.shape[axis],) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
        out[self.axis_index(axis)] = x
        return self._all_reduce(out, axis, dist.ReduceOp.SUM, "all_gather")

    def reduce(self, x: torch.Tensor, axes, kind: str = "all_reduce",
               op: str = "sum") -> torch.Tensor:
        """Σ (``op="max"``: the max) of ``x`` over ``axes`` as a NEW tensor
        (``x`` is left as it is; with no axis of extent over 1, ``x``
        itself), counted under ``kind`` in ``traffic``."""
        axes = tuple(a for a in self._axes(axes) if self.shape[a] > 1)
        if not axes:
            return x
        y = x.clone(memory_format=torch.contiguous_format)
        return self._all_reduce(y, axes, dist.ReduceOp.MAX if op == "max"
                                else dist.ReduceOp.SUM, kind)

    def barrier(self) -> None:
        """Every rank waits for all (under ``voting`` the vote is the
        barrier)."""
        if self.voting:
            self.agree()
        else:
            dist.barrier()

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, backend={self.backend!r})")


class PlanMesh(ProcessMesh):
    """A process mesh with no process group, to plan one rank's step
    (``launch/dryrun.py``): the grid's axes and extents, the coordinates
    of ``rank`` on it, and collectives that move nothing. ``psum``,
    ``pmin`` and ``pmax`` return ``x`` (in place, as a real mesh does),
    ``all_gather`` and ``reduce`` a new tensor of the result's shape on
    ``x``'s device (a meta tensor in a plan), each counted in
    ``traffic`` as ``ProcessMesh`` counts it; ``vote``, ``agree`` and
    ``barrier`` do nothing. The sharded model and the train and serve
    steps run on it unchanged."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0):
        shape = tuple(int(e) for e in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "must pair one extent with each distinct name")
        world = int(np.prod(shape))
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not on a grid of {world}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.rank = int(rank)
        self.backend = "plan"
        self.ranks = np.arange(world).reshape(shape)
        self.coords = {a: int(c) for a, c in
                       zip(names, np.unravel_index(self.rank, shape))}
        self.voting = False
        self.traffic = {}
        self._groups = {}

    def ensure_groups(self, axis_sets) -> None:
        pass

    def vote(self, row: np.ndarray | None = None) -> np.ndarray:
        return np.zeros((self.ranks.size, 1 + VOTE_NAME_CHARS), np.int32)

    def agree(self, row: np.ndarray | None = None) -> None:
        pass

    def barrier(self) -> None:
        pass

    def _all_reduce(self, x: torch.Tensor, axes, op, kind: str
                    ) -> torch.Tensor:
        if isinstance(axes, str) or len(tuple(axes)):
            self.record(kind, x, axes)
        return x

    def __repr__(self) -> str:
        return f"PlanMesh({self.shape}, rank={self.rank})"


# ---------------------------------------------------------------------------
# specs and rules: the reference's, over a ProcessMesh or a MeshShape
# ---------------------------------------------------------------------------

class MeshShape:
    """Axis names and extents, no process group: a mesh to plan with
    (the rule functions read only ``.shape``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(tuple(shape)) != len(tuple(axis_names)):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(e) for e in shape)))

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), an axis name, or a tuple of
    axis names (the dim split over their product, the first axis
    outermost), as ``jax.sharding.PartitionSpec``, which also writes a
    tuple of one axis as the axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis a spec names, in the order it names them."""
    out: list[str] = []
    for e in spec:
        for a in ((e,) if isinstance(e, str) else tuple(e or ())):
            if a not in out:
                out.append(a)
    return tuple(out)


def safe_spec(mesh, dims: Sequence[int],
              wanted: Sequence[str | tuple[str, ...] | None]
              ) -> PartitionSpec:
    """PartitionSpec assigning each wanted axis only if the dim divides.

    ``wanted[i]`` is the mesh axis (or axis tuple) desired for dim i, or
    None to replicate. Non-dividing assignments degrade to replication
    (after trying the tuple's prefixes); an axis serves one dim at most.
    """
    if len(dims) != len(wanted):
        raise ValueError(f"{len(dims)} dims but {len(wanted)} wanted axes")
    out: list = []
    used: set = set()
    for dim, want in zip(dims, wanted):
        if want is None:
            out.append(None)
            continue
        axes = (want,) if isinstance(want, str) else tuple(want)
        axes = tuple(a for a in axes if a not in used)   # one use per axis
        size = mesh_axis_size(mesh, axes)
        if axes and size > 1 and dim % size == 0:
            used.update(axes)
            out.append(axes[0] if len(axes) == 1 else axes)
        else:
            for cut in range(len(axes) - 1, 0, -1):
                sz = mesh_axis_size(mesh, axes[:cut])
                if sz > 1 and dim % sz == 0:
                    used.update(axes[:cut])
                    out.append(axes[:cut])
                    break
            else:
                out.append(None)
    return PartitionSpec(*out)


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """Maps logical activation axes to mesh axes, as the reference's.

    policy "tp" (default): batch over the data axes, heads, ffn, vocab
    and experts over ``model``. "dp", "fsdp" and "ep": batch over every
    axis, nothing tensor-shards ("ep": the experts over ``model``).

    ``batch``, the port's addition, is the axes one step's rows are
    really split over (``batch_shardings`` of its micro-batch; None:
    the table's). The sharded model reads it: a loss's token count and
    the MoE route depend on it. ``gather`` (param path → spec) names the
    entries a stored param block is split on beyond the layout the
    layers compute on (fsdp: every axis; serving: ZeRO-1's data axes):
    a layer gathers them on use (``layers.gather_params``). ``cache``
    (cache path → spec) is the layout of a decode cache's blocks
    (``partition.cache_specs``), which decode reads to find its offsets.
    """
    mesh: object
    table: dict = None
    policy: str = "tp"
    batch: tuple | None = None
    gather: dict | None = None
    cache: dict | None = None

    def __post_init__(self):
        if self.table is None:
            if self.policy in ("dp", "fsdp", "ep"):
                all_axes = batch_axes(self.mesh) + (
                    ("model",) if "model" in self.mesh.shape else ())
                d = {"batch": all_axes, "seq": None, "seq_tp": None,
                     "kv_seq": None, "heads": None, "kv_heads": None,
                     "ffn": None, "vocab": None,
                     "experts": "model" if self.policy == "ep" else None,
                     "embed": None, "state": None}
            else:
                d = {"batch": batch_axes(self.mesh), "seq": None,
                     "seq_tp": "model", "kv_seq": "model",
                     "heads": "model", "kv_heads": "model", "ffn": "model",
                     "vocab": "model", "experts": "model", "embed": None,
                     "state": None}
            object.__setattr__(self, "table", d)
        if self.batch is None:
            want = self.table.get("batch")
            object.__setattr__(self, "batch", tuple(
                (want,) if isinstance(want, str) else (want or ())))

    def spec(self, dims, logical) -> PartitionSpec:
        wanted = [self.table.get(a) if a else None for a in logical]
        return safe_spec(self.mesh, dims, wanted)

    def model_size(self) -> int:
        return self.mesh.shape.get("model", 1)


_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "logical_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: LogicalRules | None):
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def current_rules() -> LogicalRules | None:
    return _RULES.get()


# ---------------------------------------------------------------------------
# a rank's block of a spec
# ---------------------------------------------------------------------------

def axes_index(mesh, axes) -> int:
    """This rank's index along ``axes`` taken together (row-major, the
    first axis outermost, as a spec entry's tuple orders them)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def _block(spec, shape, mesh) -> tuple:
    """The slices of this rank's block of a tensor of ``shape``."""
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if e is None:
            out.append(slice(None))
            continue
        n = mesh_axis_size(mesh, e)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways (spec {spec})")
        i = axes_index(mesh, e)
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def shard_leaf(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a copy, contiguous).
    A spec shorter than the tensor names its trailing dims (a stacked
    leaf's spec cuts one layer of it)."""
    spec = tuple(spec)[max(len(spec) - full.ndim, 0):]
    spec = (None,) * (full.ndim - len(spec)) + spec
    return full[_block(spec, full.shape, mesh)].clone(
        memory_format=torch.contiguous_format)


def gather_leaf(local: torch.Tensor, spec, mesh,
                kind: str = "all_gather") -> torch.Tensor:
    """The full tensor from every rank's block under ``spec`` (a sum of
    zero buffers with one block written: exact)."""
    spec = tuple(spec) + (None,) * (local.ndim - len(spec))
    full_shape = [d * mesh_axis_size(mesh, e) if e is not None else d
                  for d, e in zip(local.shape, spec)]
    buf = local.new_zeros(full_shape)
    buf[_block(spec, full_shape, mesh)] = local
    return mesh.reduce(buf, spec_axes(spec), kind)


# ---------------------------------------------------------------------------
# differentiable collectives (Megatron's f and g, and friends)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n, i = mesh.shape[axis], mesh.coords[axis]
    shape = list(x.shape)
    w = shape[dim]
    shape[dim] = w * n
    buf = x.new_zeros(shape)
    buf.narrow(dim, i * w, w).copy_(x)
    return mesh.reduce(buf, axis, "all_gather")


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.mesh.shape[ctx.axis], ctx.mesh.coords[ctx.axis]
        w = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, i * w, w).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n, i = mesh.shape[axis], mesh.coords[axis]
        w = x.shape[dim] // n
        return x.narrow(dim, i * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def _a2a(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """out[j] = rank j's x[me] along ``axis``; x is (P, ...)."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[i] = x
    return mesh.reduce(buf, axis, "all_to_all")[:, i].contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.axis), None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.mesh.shape[ctx.axis], ctx.mesh.coords[ctx.axis]
        w = g.shape[ctx.dim] // n
        s = ctx.mesh.reduce(g, ctx.axis, "reduce_scatter")
        return s.narrow(ctx.dim, i * w, w).contiguous(), None, None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return gather_leaf(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return shard_leaf(ctx.mesh.reduce(g, spec_axes(ctx.spec),
                                          "reduce_scatter"),
                          ctx.spec, ctx.mesh), None, None


def gather_param(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec``; the
    gradient is summed over the spec's axes and cut to this rank's block
    (a reduce-scatter): right where each rank of those axes uses the
    gathered tensor on its own rows."""
    if not any(mesh.shape[a] > 1 for a in spec_axes(spec)):
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return gather_leaf(x, spec, mesh)
    return _GatherParam.apply(x, mesh, tuple(spec))


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis``: where a
    replicated tensor enters rank-different work (a column-parallel
    matmul, a replicated weight on a rank's own tokens)."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Σ over ``axis`` forward; the gradient passed through: the end of a
    row-parallel matmul, or of any partial sums."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather_along(x: torch.Tensor, mesh, axis: str, dim: int
                 ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in coordinate order;
    the gradient is this rank's slice (the result is used alike on every
    rank)."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.ndim)


def scatter_along(x: torch.Tensor, mesh, axis: str, dim: int
                  ) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim``; the
    gradient is every rank's slice gathered."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    return _Scatter.apply(x, mesh, axis, dim % x.ndim)


def all_to_all(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """x: (P, ...); row j goes to the rank at coordinate j, and row j of
    the result came from it (``jax.lax.all_to_all(x, axis, 0, 0,
    tiled=False)``). Its own adjoint. Integer tensors pass without
    autograd."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    if not x.is_floating_point():
        return _a2a(x, mesh, axis)
    return _AllToAll.apply(x, mesh, axis)


def gather_rs(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in coordinate order,
    as ``gather_along``; but the gradient is summed over ``axis`` before
    this rank's slice is cut (a reduce-scatter): right where each rank
    uses the gathered tensor on its own work (its queries, its rows)."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _gather(x, mesh, axis, dim % x.ndim)
    return _GatherRS.apply(x, mesh, axis, dim % x.ndim)


def swap_along(x: torch.Tensor, mesh, axis: str, split: int, cat: int
               ) -> torch.Tensor:
    """An all-to-all over ``axis``: ``x``'s dim ``split`` cut in P blocks,
    block j sent to the rank at coordinate j, and the blocks received
    concatenated along dim ``cat`` in coordinate order (a sequence block
    with every column from every rank's column block, and back). Its
    adjoint is the swap the other way."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    got = all_to_all(torch.stack(x.chunk(n, dim=split)), mesh, axis)
    return torch.cat(got.unbind(0), dim=cat)


def reduce_scatter_along(x: torch.Tensor, mesh, axis: str, dim: int
                         ) -> torch.Tensor:
    """Σ over ``axis`` of every rank's ``x``, cut to this rank's block
    along ``dim`` (an all-to-all of the blocks, summed in coordinate
    order); the gradient is every rank's block gathered: where each
    rank's partial sums feed every rank's rows."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    return all_to_all(torch.stack(x.chunk(n, dim=dim)), mesh, axis).sum(0)
