"""Meshes: the port of ``src/repro/launch/mesh.py``.

FUNCTIONS, not module constants: importing this module touches no
process group. ``make_production_mesh`` and ``make_lda_mesh`` lay out
the ranks of an already initialized default group
(``torch.distributed.init_process_group``; ``torchrun`` sets its
environment) and never initialize one themselves.
``production_mesh_shape`` is the same grid as a ``MeshShape``, with no
process group, to plan with (the partition rules read only its shape;
the dry-run and roofline, ROADMAP.md Queue 1 #14d, will too).
"""

from __future__ import annotations

import numpy as np

from repro_torch.runtime.sharding import MeshShape, ProcessMesh

__all__ = ["make_production_mesh", "production_mesh_shape", "make_lda_mesh"]


def _production(multi_pod: bool) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """16 × 16 (256 ranks) or 2 × 16 × 16 (512) as axis extents only."""
    return MeshShape(*_production(multi_pod))


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The default group as a 16 × 16 (data, model) mesh, or 2 × 16 × 16
    (pod, data, model) with ``multi_pod``. Any other world size raises:
    the reference takes the first devices of a larger set, but a rank
    outside the grid would have nothing to run."""
    import torch.distributed as dist
    shape, axes = _production(multi_pod)
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) lays out "
            f"{need} ranks as {dict(zip(axes, shape))}, but the default "
            f"process group has {world or 'no'} ranks; plan with "
            "production_mesh_shape() instead")
    return ProcessMesh(shape, axes)


def make_lda_mesh(n_data: int, n_model: int, *,
                  n_pod: int | None = None) -> ProcessMesh:
    """A (data, model) mesh, or (pod, data, model) with ``n_pod``."""
    if n_pod:
        return ProcessMesh((n_pod, n_data, n_model),
                           ("pod", "data", "model"))
    return ProcessMesh((n_data, n_model), ("data", "model"))
