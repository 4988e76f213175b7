"""Serving steps: batched single-token decode and prefill, on one device
or sharded over a process mesh. Port of ``src/repro/train/serve_step.py``.

``serve_step(params, cache, tokens)`` decodes one new token for every
sequence against the KV cache (written in place, ``length`` advanced);
``prefill_step(params, inputs)`` returns the last position's logits.
Both run without autograd.

On a ``ProcessMesh`` of more than one rank every rank calls a step with
the same GLOBAL tokens or inputs, and the step is the reference's
sharded serving made explicit (GSPMD derives it from the shardings of
``serve_state_shardings`` there):

* each rank holds its block of the params under
  ``partition.zero1_specs`` (the ``tp`` policy: tensor-parallel over
  ``model``, plus a data-axis shard of the largest free dim, so a large
  model fits beside its cache); a layer's leaves are gathered over the
  data axes when the layer runs, back to the ``tp`` layout, and never
  the whole model at once (``LogicalRules.gather``);
* each rank holds its block of the cache under ``partition.cache_specs``
  (``registry.make_rank_cache``): the KV sequence over ``model`` with
  the batch over the data axes, or at batch 1 the heads over them; MLA's
  compressed cache's sequence over ``model``; the SSM state's heads over
  ``model``; decode is the distributed flash-decode of
  ``attention.cached_attention``;
* a rank runs its rows of the batch (the data axes' block, or every row
  where the batch does not divide them) and returns its block of the
  logits under ``logits_spec`` (the reference's ``[batch_axes,
  "model"]``); ``runtime.sharding.gather_leaf`` puts them together.

``make_fill_step`` is the port's sharded ``encdec.fill_cross_cache``
(the reference has none: its cross cache stays zero).
"""

from __future__ import annotations

from repro_torch.models import encdec, transformer
from repro_torch.models.registry import (ModelApi, cache_shapes,
                                         param_shapes)
from repro_torch.models.tree import tree_items
from repro_torch.runtime.sharding import (LogicalRules, PartitionSpec,
                                          ProcessMesh, batch_axes,
                                          safe_spec, spec_axes, use_rules)
from repro_torch.train import partition
from repro_torch.train.train_step import _Layout, batch_rows, mesh_size

__all__ = ["make_serve_step", "make_prefill_step", "make_fill_step",
           "serve_state_shardings", "logits_spec"]


def serve_state_shardings(api: ModelApi, mesh, batch: int, max_len: int,
                          enc_len: int | None = None):
    """(params' shapes, cache's shapes, params' specs, cache's specs): the
    params under ``zero1_specs`` (serving has no gradients, so they
    shard over the data axes as well), the cache under
    ``cache_specs``."""
    params_shape = param_shapes(api.cfg)
    cache_shape = cache_shapes(api.cfg, batch, max_len, enc_len)
    return (params_shape, cache_shape,
            partition.zero1_specs(mesh, params_shape),
            partition.cache_specs(mesh, cache_shape))


def logits_spec(mesh, batch: int, vocab: int) -> PartitionSpec:
    """The spec of a step's (batch, padded vocab) logits on ``mesh``."""
    return safe_spec(mesh, (batch, vocab), [batch_axes(mesh), "model"])


def _sharded(api: ModelApi, mesh, what: str, cache_specs=None,
             needs_cache: bool = True):
    """rules_rows(n) → (the rules for a batch of n rows, this rank's rows
    of n)."""
    transformer.check_sharded(api.cfg, mesh, "tp")
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(
            f"{what} on a mesh of {dict(mesh.shape)} needs a ProcessMesh "
            f"over an initialized process group, not {type(mesh).__name__}")
    if needs_cache and cache_specs is None:
        raise ValueError(f"{what} on a mesh needs cache_specs, the cache's "
                         "layout (serve_state_shardings)")
    gather = _Layout(api.cfg, mesh, "tp").extra
    cache = None if cache_specs is None else dict(tree_items(cache_specs))

    def rules_rows(n: int):
        spec = safe_spec(mesh, (n,), [batch_axes(mesh)])
        rules = LogicalRules(mesh, batch=spec_axes(spec), gather=gather,
                             cache=cache)
        return rules, batch_rows(mesh, spec, n)

    return rules_rows


def make_serve_step(api: ModelApi, mesh=None, cache_specs=None):
    """serve_step(params, cache, tokens) → (logits, cache). On a mesh of
    more than one rank ``cache_specs`` is the cache's layout
    (``serve_state_shardings``), ``params`` and ``cache`` this rank's
    blocks, ``tokens`` the global (B, 1), and the logits this rank's
    block under ``logits_spec``."""
    if mesh_size(mesh) == 1:
        def serve_step(params, cache, tokens):
            return api.decode(params, cache, tokens)

        return serve_step
    rules_rows = _sharded(api, mesh, "make_serve_step", cache_specs)

    def serve_step(params, cache, tokens):
        rules, rows = rules_rows(tokens.shape[0])
        with use_rules(rules):
            return api.decode(params, cache, tokens[rows])

    return serve_step


def make_prefill_step(api: ModelApi, mesh=None):
    """prefill(params, batch_inputs) → last-position logits (the
    encoder-decoder: the encoder's output, as the reference's). On a
    mesh: this rank's blocks of the params and its block of the
    result."""
    if mesh_size(mesh) == 1:
        def prefill_step(params, inputs):
            return api.prefill(params, inputs)

        return prefill_step
    rules_rows = _sharded(api, mesh, "make_prefill_step", needs_cache=False)

    def prefill_step(params, inputs):
        rules, rows = rules_rows(inputs.shape[0])
        with use_rules(rules):
            return api.prefill(params, inputs[rows])

    return prefill_step


def make_fill_step(api: ModelApi, mesh=None, cache_specs=None):
    """fill(params, cache, frames) → the encoder's output: the
    encoder-decoder's cross K/V written into ``cache`` in place
    (``encdec.fill_cross_cache``); on a mesh from the global frames, into
    this rank's blocks."""
    if mesh_size(mesh) == 1:
        def fill(params, cache, frames):
            return encdec.fill_cross_cache(params, cache, frames, api.cfg)

        return fill
    rules_rows = _sharded(api, mesh, "make_fill_step", cache_specs)

    def fill(params, cache, frames):
        rules, rows = rules_rows(frames.shape[0])
        with use_rules(rules):
            return encdec.fill_cross_cache(params, cache, frames[rows],
                                           api.cfg)

    return fill
