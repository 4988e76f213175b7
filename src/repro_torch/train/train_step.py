"""The training step: micro-batched gradient accumulation and AdamW, on
one device or sharded over a process mesh with ZeRO-1. Port of
``src/repro/train/train_step.py``.

``make_train_step`` returns ``(train_step, init_state)`` with the
reference's state layout ``{"params", "opt", "step"}`` and metrics
``{"loss", "grad_norm", "lr"}``. The batch is split into ``n_micro``
micro-batches as the reference reshapes it; each micro-batch's gradients
(``torch.autograd.grad`` over the params' leaves, each block recomputed
under ``torch.utils.checkpoint``) accumulate in float32 with
``rs_per_micro=True`` and in the param dtype with ``False``, as the
reference's two accumulation schedules do; the sum is divided by
``n_micro`` and AdamW runs. The step runs eagerly: a new state replaces
the old one, whose tensors the caller drops.

``mesh=None``, or a process mesh of one rank, is one device. On a
``ProcessMesh`` of more than one rank every rank calls the step with the
same GLOBAL batch, and the step is the reference's sharded schedule made
explicit (GSPMD derives it from the specs there):

* each rank holds its block of every param (``partition.param_specs``
  under ``policy``: "tp", the default, "dp" or "ep") and of the float32
  master, m and v (``partition.zero1_specs``: ZeRO-1);
* a micro-batch is the reference's: rows ``[i·B/n, (i+1)·B/n)`` of the
  global batch, of which a rank takes its block over the batch's axes
  (``batch_shardings``), not a block of the global batch cut first;
* the model runs under ``use_rules`` (tensor-parallel layers, MoE
  routes); a rank's loss is its local sum over the micro-batch's global
  token count, so the gradients summed over the batch's axes are the
  one-device gradients;
* each leaf's gradient is summed over the batch axes it is not sharded
  on and cut to its ZeRO-1 block: every micro-batch
  (``rs_per_micro=True``, then cast and accumulated in float32) or once
  at the step's end in the param dtype (``False``). The sum is an
  all-reduce of the param-layout gradient (``ProcessMesh.reduce``); a
  native reduce-scatter is performance work (ROADMAP.md);
* AdamW runs on the blocks, the clip's norm summing each leaf's
  distinct blocks once; the new params are the masters cast and
  gathered back to the param layout (ZeRO's all-gather).

``train_state_specs``, ``batch_shardings`` and ``batch_rows`` give the
spec trees and a rank's rows; ``full_state`` and ``local_state`` carry a
sharded state to the one-device layout and back (checkpoints). The fsdp
policy, and the families the sharded model does not run, wait for
ROADMAP.md Queue 1 #14c-2 (``transformer.check_sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.registry import ModelApi, param_shapes
from repro_torch.models.tree import (tree_from_items, tree_items,
                                     tree_leaves, tree_map, tree_unflatten)
from repro_torch.runtime.sharding import (LogicalRules, PartitionSpec as P,
                                          ProcessMesh, axes_index,
                                          batch_axes, gather_leaf,
                                          mesh_axis_size, safe_spec,
                                          shard_leaf, spec_axes, use_rules)
from repro_torch.train import partition
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)

__all__ = ["make_train_step", "default_microbatches", "train_state_specs",
           "batch_shardings", "batch_rows", "full_state", "full_opt_items",
           "local_state", "mesh_size"]


def mesh_size(mesh) -> int:
    """The ranks of a mesh (1 for None)."""
    return 1 if mesh is None else int(np.prod(list(mesh.shape.values())))


def default_microbatches(cfg, shape, mesh=None, policy: str = "tp") -> int:
    """Microbatch count so per-device activations fit with full remat.

    Heuristic keyed on model size: bigger d_model ⇒ smaller microbatch.
    Must divide the per-device batch. With no mesh the whole batch is on
    one device.
    """
    n_data = 1
    if mesh is not None:
        axes = batch_axes(mesh)
        if policy in ("dp", "fsdp", "ep") and "model" in mesh.shape:
            axes = axes + ("model",)
        for a in axes:
            n_data *= mesh.shape[a]
    local_batch = max(shape.global_batch // n_data, 1)
    if cfg.d_model >= 5000:
        want = local_batch            # one sequence per microbatch
    elif cfg.d_model >= 2000:
        want = max(local_batch // 4, 1)
    else:
        want = max(local_batch // 8, 1)
    while local_batch % want:
        want -= 1
    return max(want, 1)


def batch_shardings(mesh, batch_specs: dict, policy: str = "tp") -> dict:
    """The batch dim over (pod, data), plus ``model`` under the dp, fsdp
    and ep policies: a PartitionSpec a key (``batch_specs``' leaves have
    ``.shape``)."""
    daxes = batch_axes(mesh)
    if policy in ("dp", "fsdp", "ep") and "model" in mesh.shape:
        daxes = daxes + ("model",)
    return {k: safe_spec(mesh, v.shape, [daxes] + [None] * (len(v.shape)
                                                            - 1))
            for k, v in batch_specs.items()}


def batch_rows(mesh, spec, n: int) -> slice:
    """This rank's rows of ``n`` under a batch ``spec``."""
    e = spec[0] if len(spec) else None
    if e is None:
        return slice(0, n)
    w = n // mesh_axis_size(mesh, e)
    i = axes_index(mesh, e)
    return slice(i * w, (i + 1) * w)


def train_state_specs(mesh, params_shape, policy: str = "tp") -> dict:
    """Specs of the train state: params at ``param_specs``, the float32
    master, m and v at ``zero1_specs``, count and step replicated."""
    p_spec = partition.param_specs(mesh, params_shape, policy)
    z_spec = partition.zero1_specs(mesh, params_shape, policy)
    return {"params": p_spec,
            "opt": {"master": z_spec, "m": z_spec, "v": z_spec,
                    "count": P()},
            "step": P()}


class _Layout:
    """Each leaf's param spec, ZeRO-1 spec and the entries ZeRO-1 adds
    (``extra``), in leaf order, for one model, mesh and policy."""

    def __init__(self, cfg, mesh, policy: str):
        shapes = param_shapes(cfg)
        self.p = dict(tree_items(partition.param_specs(mesh, shapes,
                                                       policy)))
        self.z = dict(tree_items(partition.zero1_specs(mesh, shapes,
                                                       policy)))
        self.paths = [path for path, _ in tree_items(shapes)]
        self.extra = {}
        for path in self.paths:
            p, z = tuple(self.p[path]), tuple(self.z[path])
            p = p + (None,) * (len(z) - len(p))
            if any(a is not None and a != b for a, b in zip(p, z)):
                raise ValueError(f"{path}: ZeRO-1 spec {z} does not extend "
                                 f"the param spec {p}")
            self.extra[path] = P(*(b if a is None else None
                                   for a, b in zip(p, z)))
        mesh.ensure_groups([spec_axes(s) for d in (self.p, self.z,
                                                   self.extra)
                            for s in d.values()])


def _sq_sum(mesh, layout: _Layout):
    """Σ over leaves of Σg² on ZeRO-1 blocks, each leaf's distinct blocks
    counted once: a rank adds a leaf's squares only at coordinate 0 of
    every axis the leaf's block is replicated over."""
    def owner(path):
        axes = spec_axes(layout.z[path])
        return all(mesh.coords[a] == 0 for a in mesh.axis_names
                   if a not in axes)

    mine = [owner(path) for path in layout.paths]

    def total(sq):
        vec = torch.stack([s if m else torch.zeros_like(s)
                           for s, m in zip(sq, mine)])
        return sum(mesh.reduce(vec, mesh.axis_names).unbind())

    return total


def full_opt_items(state: dict, api: ModelApi, mesh, policy: str = "tp"):
    """``(part, path, full leaf)`` of the master, m and v, a leaf at a
    time, gathered from every rank's ZeRO-1 blocks (collective: every
    rank walks it to the end)."""
    layout = None if mesh_size(mesh) == 1 else _Layout(api.cfg, mesh,
                                                       policy)
    for part in ("master", "m", "v"):
        for path, t in tree_items(state["opt"][part]):
            yield part, path, t if layout is None else gather_leaf(
                t, layout.z[path], mesh, "checkpoint")


def full_state(state: dict, api: ModelApi, mesh, policy: str = "tp"
               ) -> dict:
    """The one-device train state from every rank's ZeRO-1 blocks
    (collective). Params are the master cast, bitwise what AdamW makes
    of it."""
    if mesh_size(mesh) == 1:
        return state
    items: dict = {"master": [], "m": [], "v": []}
    for part, path, t in full_opt_items(state, api, mesh, policy):
        items[part].append((path, t))
    opt = {part: tree_from_items(v) for part, v in items.items()}
    opt["count"] = state["opt"]["count"]
    return {"params": tree_map(lambda w: w.to(api.cfg.dtype, copy=True),
                               opt["master"]),
            "opt": opt, "step": state["step"]}


def local_state(full: dict, api: ModelApi, mesh, policy: str = "tp"
                ) -> dict:
    """This rank's blocks of a one-device train state (the inverse of
    ``full_state``): params cut from the master cast."""
    if mesh_size(mesh) == 1:
        return full
    layout = _Layout(api.cfg, mesh, policy)
    opt = {part: tree_from_items(
        (path, shard_leaf(t, layout.z[path], mesh))
        for path, t in tree_items(full["opt"][part]))
        for part in ("master", "m", "v")}
    opt["count"] = full["opt"]["count"]
    params = tree_from_items(
        (path, shard_leaf(t.to(api.cfg.dtype), layout.p[path], mesh))
        for path, t in tree_items(full["opt"]["master"]))
    return {"params": params, "opt": opt, "step": full["step"]}


def make_train_step(api: ModelApi, mesh=None, n_micro: int = 1,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    policy: str = "tp", rs_per_micro: bool = True):
    """Returns (train_step, init_state). train_step: (state, batch) →
    (new_state, metrics), on ``api.device``; init_state: (seed, params=
    None) → state (``params``: this rank's blocks of given weights, in
    place of the init).

    rs_per_micro=False accumulates micro-grads in the param dtype at the
    param layout and reduces them once per step (one device: upcasts
    once), as the reference's once-per-step reduce-scatter schedule does.
    """
    if mesh_size(mesh) == 1:
        return _one_device_step(api, n_micro, opt_cfg, rs_per_micro)
    transformer.check_sharded(api.cfg, mesh, policy)
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(
            f"make_train_step on a mesh of {dict(mesh.shape)} needs a "
            f"ProcessMesh over an initialized process group, not "
            f"{type(mesh).__name__} (a MeshShape only plans)")
    return _sharded_step(api, mesh, n_micro, opt_cfg, policy, rs_per_micro)


def _one_device_step(api, n_micro, opt_cfg, rs_per_micro):
    def init_state(seed: int = 0, params: dict | None = None) -> dict:
        if params is None:
            params = api.init(seed)
        return {"params": params, "opt": init_opt_state(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=api.device)}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        leaves = tree_leaves(params)

        def micro(x, i):
            mb = x.shape[0] // n_micro
            return x.reshape((n_micro, mb) + x.shape[1:])[i]

        if rs_per_micro:
            acc = [torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for p in leaves]
        else:
            acc = [torch.zeros_like(p, requires_grad=False) for p in leaves]
        losses = []
        for i in range(n_micro):
            mb = {k: micro(v, i) for k, v in batch.items()}
            loss = api.loss(params, mb)
            grads = _grads(loss, leaves)
            if rs_per_micro:
                acc = [a + g.float() for a, g in zip(acc, grads)]
            else:
                acc = [a + g for a, g in zip(acc, grads)]
            losses.append(loss.detach())
            del loss, grads
        grads = tree_unflatten(params, (a.float() / n_micro for a in acc))
        del acc
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, state["opt"], param_dtype=api.cfg.dtype)
        metrics["loss"] = torch.stack(losses).mean()
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step, init_state


def _grads(loss, leaves) -> list:
    # an embedding-input config never reads the embedding table in
    # training: its gradient is zero, as jax.grad gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _sharded_step(api, mesh, n_micro, opt_cfg, policy, rs_per_micro):
    cfg = api.cfg
    layout = _Layout(cfg, mesh, policy)
    sq_sum = _sq_sum(mesh, layout)

    def init_state(seed: int = 0, params: dict | None = None) -> dict:
        if params is None:
            params = transformer.init_lm(
                cfg, seed, api.device,
                keep=lambda path, t: shard_leaf(t, layout.p[path], mesh))
        master = tree_from_items(
            (path, shard_leaf(t.detach().float(), layout.extra[path], mesh))
            for path, t in tree_items(params))
        return {"params": params,
                "opt": {"master": master,
                        "m": tree_map(torch.zeros_like, master),
                        "v": tree_map(torch.zeros_like, master),
                        "count": torch.zeros((), dtype=torch.int32,
                                             device=api.device)},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=api.device)}

    def to_zero1(g, path, axes):
        """A param-layout gradient summed over ``axes`` and cut to this
        rank's ZeRO-1 block."""
        return shard_leaf(mesh.reduce(g, axes, "reduce_scatter"),
                          layout.extra[path], mesh)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        n_rows = next(iter(batch.values())).shape[0]
        mb = n_rows // n_micro
        spec = batch_shardings(mesh, {k: v[:mb] for k, v in batch.items()},
                               policy)
        used = spec_axes(next(iter(spec.values())))
        rows = batch_rows(mesh, next(iter(spec.values())), mb)
        axes = {path: tuple(a for a in used
                            if a not in spec_axes(layout.p[path]))
                for path in layout.paths}
        mesh.ensure_groups([used, *axes.values()])
        rules = LogicalRules(mesh, policy=policy, batch=used)
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        leaves = tree_leaves(params)
        acc, losses = None, []
        with use_rules(rules):
            for i in range(n_micro):
                mb_i = {k: v[i * mb:(i + 1) * mb][rows]
                        for k, v in batch.items()}
                loss = api.loss(params, mb_i)
                grads = _grads(loss, leaves)
                if rs_per_micro:
                    grads = [to_zero1(g, path, axes[path]).float()
                             for g, path in zip(grads, layout.paths)]
                acc = grads if acc is None else [
                    a + g for a, g in zip(acc, grads)]
                losses.append(loss.detach())
                del loss, grads
        if not rs_per_micro:
            acc = [to_zero1(a, path, axes[path]).float()
                   for a, path in zip(acc, layout.paths)]
        grads = tree_unflatten(params, (a / n_micro for a in acc))
        del acc
        new_z, new_opt, metrics = adamw_update(
            opt_cfg, grads, state["opt"], param_dtype=cfg.dtype,
            sq_sum=sq_sum)
        new_params = tree_from_items(
            (path, gather_leaf(w, layout.extra[path], mesh))
            for path, w in tree_items(new_z))
        metrics["loss"] = mesh.reduce(torch.stack(losses).mean(), used)
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step, init_state
