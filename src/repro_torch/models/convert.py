"""Params across the packages, bitwise: the reference's param pytree
(``src/repro/models/transformer.py::init_lm`` and
``encdec.py::init_encdec``: stacked blocks, ``{"w", "b"}`` linears,
``{"scale"}`` norms, ``{"table"}`` embedding, ``head`` when untied,
zamba2's ``shared_attn``, the MoE expert stacks) into the port and back.

Both packages keep the same paths and the same ``(d_in, d_out)`` weight
layout, so a leaf crosses as one copy. The reference side is a nested
dict of NumPy arrays (``jax.tree.map(np.asarray, params)``); bfloat16
leaves there are ``ml_dtypes.bfloat16`` arrays, which cross as their
16-bit patterns. The same functions carry any such tree (optimizer
state, gradients).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import tree_from_items, tree_items, tree_map
from repro_torch.runtime.device import resolve_device

__all__ = ["params_from_reference", "params_to_reference", "FLOAT32_LEAVES"]

# leaves the reference draws in float32 whatever the param dtype: the MoE
# router and the SSM's A, dt bias and skip (AdamW casts them to the param
# dtype from the first step on, as it casts every leaf)
FLOAT32_LEAVES = ("router", "a_log", "dt_bias", "d_skip")


def _bits(a) -> np.ndarray:
    """``a`` as an array torch takes (bfloat16 as its 16-bit patterns)."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                    # numpy's bfloat16, as jax's
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_reference(tree: dict, cfg: ModelConfig | None = None,
                          device=None, mesh=None,
                          policy: str = "tp") -> dict:
    """The reference's tree of arrays as the port's tree of tensors on
    ``device`` (None: the CUDA card), bit for bit. With ``cfg``, every
    floating leaf must already be in ``cfg.param_dtype``, but those of
    ``FLOAT32_LEAVES``, which may also be float32. With a process
    ``mesh`` each leaf is this rank's block of ``policy``'s param spec
    (``train/partition.py::param_specs``), cut before it is copied."""
    dev = resolve_device(device)
    if mesh is None:
        out = tree_map(lambda a: _to_torch(a, dev), tree)
    else:
        from repro_torch.runtime.sharding import shard_leaf
        from repro_torch.train.partition import param_specs
        specs = dict(tree_items(param_specs(
            mesh, tree_map(lambda a: np.asarray(a), tree), policy)))
        out = tree_from_items(
            (path, _to_torch(shard_leaf(torch.from_numpy(_bits(a)),
                                        specs[path], mesh).numpy()
                             .view(np.asarray(a).dtype), dev))
            for path, a in tree_items(tree))
    if cfg is not None:
        def ok(path, t):
            return (not t.is_floating_point() or t.dtype == cfg.dtype
                    or (t.dtype == torch.float32
                        and path.rsplit("/", 1)[-1] in FLOAT32_LEAVES))
        bad = {str(t.dtype) for path, t in tree_items(out)
               if not ok(path, t)}
        if bad:
            raise ValueError(f"params of {cfg.name} should be "
                             f"{cfg.param_dtype}, got {sorted(bad)}")
    return out


def params_to_reference(params: dict) -> dict:
    """The port's tree of tensors as a tree of NumPy arrays that
    ``jax.tree.map(jnp.asarray, ...)`` takes, bit for bit."""
    return tree_map(_to_numpy, params)
