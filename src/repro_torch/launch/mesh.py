"""Meshes for multi-GPU LDA: the port of ``src/repro/launch/mesh.py``'s
``make_lda_mesh``.

A FUNCTION, not a module constant: importing this module touches no
process group. ``make_lda_mesh`` lays out the ranks of an already
initialized default group (``torch.distributed.init_process_group``;
``torchrun`` sets its environment) and never initializes one itself.
The production mesh of the LM substrate (``make_production_mesh``)
arrives with the sharded LM, ROADMAP.md Queue 1 #14c.
"""

from __future__ import annotations

from repro_torch.runtime.sharding import ProcessMesh

__all__ = ["make_lda_mesh"]


def make_lda_mesh(n_data: int, n_model: int, *,
                  n_pod: int | None = None) -> ProcessMesh:
    """A (data, model) mesh, or (pod, data, model) with ``n_pod``."""
    if n_pod:
        return ProcessMesh((n_pod, n_data, n_model),
                           ("pod", "data", "model"))
    return ProcessMesh((n_data, n_model), ("data", "model"))
