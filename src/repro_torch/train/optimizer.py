"""AdamW with float32 master weights: port of ``src/repro/train/optimizer.py``.

The state is the reference's: ``{"master", "m", "v"}`` (float32 trees
shaped like the params) and ``count`` (int32). ``adamw_update`` clips by
the global norm, corrects the moments' bias, decays the master weights
(decoupled) and returns params as the master cast to the param dtype.
On one device there is no ZeRO-1 layout to shard the state into; that
arrives with the sharded LM (ROADMAP.md Queue 1 #14c).

Schedule: linear warmup → cosine decay to 0.1 of the peak.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "lr_at"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The float32 learning rate at ``step`` (an int or an int tensor)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                0.1 + 0.9 * cos)


def init_opt_state(params: Any) -> dict:
    """float32 master (a copy) + zero moments + count 0."""
    leaf = tree_leaves(params)[0]
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def adamw_update(cfg: AdamWConfig, grads: Any, opt: dict,
                 param_dtype=torch.bfloat16) -> tuple[Any, dict, dict]:
    """One AdamW step on float32 state; returns (new_params, new_opt,
    metrics). ``grads`` is a tree shaped like the params."""
    if isinstance(param_dtype, str):
        param_dtype = getattr(torch, param_dtype)
    count = opt["count"] + 1
    # global-norm clip (leaves summed in the reference's order)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_at(cfg, count)
    bc1 = 1 - cfg.b1 ** count.float()
    bc2 = 1 - cfg.b2 ** count.float()

    def upd(g, m, v, master):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master = master - lr * (step + cfg.weight_decay * master)
        return m, v, master

    out = tree_map(upd, grads, opt["m"], opt["v"], opt["master"])
    new_opt = {"master": tree_map(lambda t: t[2], out),
               "m": tree_map(lambda t: t[0], out),
               "v": tree_map(lambda t: t[1], out),
               "count": count}
    new_params = tree_map(lambda w: w.to(param_dtype, copy=True),
                          new_opt["master"])
    return new_params, new_opt, {"grad_norm": gnorm, "lr": lr}
