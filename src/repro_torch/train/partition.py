"""Parameter, optimizer and cache partition rules (Megatron-style, by
path): port of ``src/repro/train/partition.py``.

Tensor parallelism (the ``model`` axis):
  * embed table and lm head: the vocab dim (padded to a clean multiple);
  * attention q/k/v: the output (heads) dim; o-proj: the input dim;
  * MLP: the hidden (ffn) dim both ways;
  * MoE expert stacks: the expert dim (expert parallelism);
  * MLA low-rank projections: their rank or output dims;
  * SSM block weights stay replicated.

ZeRO-1 (the data axes): the float32 master, m and v additionally shard
their largest still-unsharded divisible dim over the data axes. A rule
that does not divide degrades to replication (``safe_spec``).

The functions take a params-shaped tree whose leaves have ``.shape``
(tensors, meta-device tensors from ``models/registry.py::param_shapes``)
and a mesh (``ProcessMesh`` or ``MeshShape``: only ``.shape`` is read),
and return a tree of ``PartitionSpec`` of the same keys. Paths are the
port's ``tree_items`` paths (``blocks/attn/wq/w``), which are the
reference's. ``shard_leaf``/``gather_leaf`` (``runtime/sharding.py``)
cut a full leaf to this rank's block of its spec and back.
"""

from __future__ import annotations

import re

from repro_torch.models.tree import tree_from_items, tree_items
from repro_torch.runtime.sharding import (PartitionSpec as P, batch_axes,
                                          mesh_axis_size, safe_spec)

__all__ = ["param_specs", "zero1_specs", "cache_specs"]

# (path regex, wanted mesh axes per trailing dim): matched right-to-left
# against the dims, so the leading layer-stack dim never needs mention
_RULES: list[tuple[str, list]] = [
    (r"embed/table$",            [("model",), None]),
    (r"head/w$",                 [None, ("model",)]),
    (r"attn/w[qkv]/w$",          [None, ("model",)]),
    (r"attn/w[qkv]/b$",          [("model",)]),
    (r"attn/wo/w$",              [("model",), None]),
    (r"xattn/w[qkv]/w$",         [None, ("model",)]),
    (r"xattn/wo/w$",             [("model",), None]),
    # MLA
    (r"attn/w_dq/w$",            [None, ("model",)]),
    (r"attn/w_uq/w$",            [None, ("model",)]),
    (r"attn/w_dkv/w$",           [None, None]),
    (r"attn/w_uk/w$",            [None, ("model",)]),
    (r"attn/w_uv/w$",            [None, ("model",)]),
    (r"attn/w_kr/w$",            [None, None]),
    # dense mlp (w_gate/w_up raw arrays for silu; dicts for gelu)
    (r"mlp/w_gate$",             [None, ("model",)]),
    (r"mlp/w_up$",               [None, ("model",)]),
    (r"mlp/w_down$",             [("model",), None]),
    (r"mlp/w_up/w$",             [None, ("model",)]),
    (r"mlp/w_up/b$",             [("model",)]),
    (r"mlp/w_down/w$",           [("model",), None]),
    # moe: expert-parallel stacks; shared experts like the dense mlp
    (r"moe/router$",             [None, None]),
    (r"moe/w_gate$",             [("model",), None, None]),
    (r"moe/w_up$",               [("model",), None, None]),
    (r"moe/w_down$",             [("model",), None, None]),
    (r"moe/shared/w_gate$",      [None, ("model",)]),
    (r"moe/shared/w_up$",        [None, ("model",)]),
    (r"moe/shared/w_down$",      [("model",), None]),
]
_EXPERTS = r"moe/w_(gate|up|down)$"


def _map(fn, tree) -> dict:
    """``fn(path, shape)`` on every leaf, as a tree of the same keys."""
    return tree_from_items((path, fn(path, tuple(leaf.shape)))
                           for path, leaf in tree_items(tree))


def _match_spec(mesh, path: str, shape: tuple[int, ...]) -> P:
    for pat, wanted in _RULES:
        if re.search(pat, path):
            if len(wanted) > len(shape):   # rule assumes more dims
                continue
            full = [None] * (len(shape) - len(wanted)) + list(wanted)
            return safe_spec(mesh, shape, full)
    return P()                 # replicate (norms, scalars, ssm, conv)


def _shard_over_all(mesh, params_shape) -> dict:
    """Every tensor's largest divisible dim sharded over ALL mesh axes
    (the FSDP layout)."""
    axes = batch_axes(mesh) + (("model",) if "model" in mesh.shape else ())
    size = mesh_axis_size(mesh, axes)

    def one(path, shape):
        cands = [(d, i) for i, d in enumerate(shape)
                 if d % size == 0 and d >= size]
        if not cands:
            return P()
        _, idx = max(cands)
        entries = [None] * len(shape)
        entries[idx] = axes if len(axes) > 1 else axes[0]
        return P(*entries)

    return _map(one, params_shape)


def param_specs(mesh, params_shape, policy: str = "tp") -> dict:
    """Tree of PartitionSpec matching a params(-shaped) tree.

    policy "dp": params replicate (the optimizer state still ZeRO-shards
    over every axis). "ep": only the routed expert stacks live on the
    model axis. "fsdp": params ZeRO-shard over every axis."""
    if policy == "dp":
        return _map(lambda path, shape: P(), params_shape)
    if policy == "ep":
        def one(path, shape):
            if re.search(_EXPERTS, path):
                return safe_spec(mesh, shape, [None, ("model",), None, None]
                                 [4 - len(shape):])
            return P()
        return _map(one, params_shape)
    if policy == "fsdp":
        return _shard_over_all(mesh, params_shape)
    return _map(lambda path, shape: _match_spec(mesh, path, shape),
                params_shape)


def zero1_specs(mesh, params_shape, policy: str = "tp") -> dict:
    """Optimizer-state specs: the param spec plus a data-axis shard of the
    largest free dim (ZeRO-1); under "dp" and "ep" over the model axis
    too."""
    if policy == "fsdp":
        return _shard_over_all(mesh, params_shape)
    daxes = batch_axes(mesh)
    if policy in ("dp", "ep") and "model" in mesh.shape:
        daxes = daxes + ("model",)
    dsize = mesh_axis_size(mesh, daxes)

    def one(path, shape):
        if policy == "dp":
            base = P()
        elif policy == "ep":
            base = _match_spec(mesh, path, shape) \
                if re.search(_EXPERTS, path) else P()
        else:
            base = _match_spec(mesh, path, shape)
        if dsize == 1:
            return base
        entries = list(base) + [None] * (len(shape) - len(base))
        dax, dsz = daxes, dsize
        if policy == "ep" and any(e is not None for e in entries):
            dax = batch_axes(mesh)             # model already used
            dsz = mesh_axis_size(mesh, dax)
        cands = [(d, i) for i, (d, e) in enumerate(zip(shape, entries))
                 if e is None and d % dsz == 0 and d >= dsz]
        if not cands:
            return base
        _, idx = max(cands)
        entries[idx] = dax if len(dax) > 1 else dax[0]
        return P(*entries)

    return _map(one, params_shape)


def cache_specs(mesh, cache_shape) -> dict:
    """Decode-cache specs. KV (L, B, S, H, D): batch over data, seq over
    model; batch 1 falls back to heads over data. SSM state (L, B, H, N,
    P): batch over data, heads over model. MLA's compressed cache (L, B,
    S, r): batch over data, seq over model."""
    daxes = batch_axes(mesh)

    def one(path, shape):
        if path in ("k", "v", "x_k", "x_v"):
            spec = safe_spec(mesh, shape, [None, daxes, "model", None, None])
            if spec[1] is None and shape[1] == 1:      # batch 1: heads→data
                spec = safe_spec(mesh, shape,
                                 [None, None, "model", daxes, None])
            return spec
        if path == "state":
            return safe_spec(mesh, shape, [None, daxes, "model", None, None])
        if path == "conv":
            return safe_spec(mesh, shape, [None, daxes, None, None])
        if path in ("c_kv", "k_rope"):
            return safe_spec(mesh, shape, [None, daxes, "model", None])
        return P()                                     # length etc.

    return _map(one, cache_shape)
