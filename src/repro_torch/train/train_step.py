"""The training step on one device: micro-batched gradient accumulation
and AdamW. Port of ``src/repro/train/train_step.py``.

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

``mesh=None``, or a process mesh of one rank, is one device. The
reference's sharded schedule (ZeRO-1 reduce-scatters, ``policy``,
``train_state_specs``, ``batch_shardings``) arrives with ROADMAP.md
Queue 1 #14c; a larger mesh raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import torch

from repro_torch.models.registry import ModelApi
from repro_torch.models.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime.sharding import batch_axes
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)

__all__ = ["make_train_step", "default_microbatches", "one_device"]


def one_device(mesh, what: str) -> None:
    """Accept no mesh or a mesh of one rank; refuse anything larger."""
    if mesh is None or all(e == 1 for e in mesh.shape.values()):
        return
    raise NotImplementedError(
        f"{what} on a mesh of {dict(mesh.shape)}: the port runs the LM on "
        "one device; the sharded LM arrives with ROADMAP.md Queue 1 #14c")


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


def make_train_step(api: ModelApi, mesh=None, n_micro: int = 1,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    rs_per_micro: bool = True):
    """Returns (train_step, init_state). train_step: (state, batch) →
    (new_state, metrics), on ``api.device``; init_state: (seed) → state.

    rs_per_micro=False accumulates micro-grads in the param dtype and
    upcasts once per step, as the reference's once-per-step
    reduce-scatter schedule does (one device has no reduce-scatter).
    """
    one_device(mesh, "make_train_step")

    def init_state(seed: int = 0) -> dict:
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
            # an embedding-input config never reads the embedding table in
            # training: its gradient is zero, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
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
