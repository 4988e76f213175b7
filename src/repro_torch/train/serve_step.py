"""Serving steps on one device: batched single-token decode and prefill.
Port of ``src/repro/train/serve_step.py``.

``serve_step(params, cache, tokens)`` decodes one new token for every
sequence against the KV cache (written in place, ``length`` advanced);
``prefill_step(params, inputs)`` returns the last position's logits.
Both run without autograd. The reference's cache and param shardings
(``serve_state_shardings``) arrive with ROADMAP.md Queue 1 #14c; a mesh
of more than one rank raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from repro_torch.models.registry import ModelApi
from repro_torch.train.train_step import one_device

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(api: ModelApi, mesh=None):
    """serve_step(params, cache, tokens) → (logits, cache)."""
    one_device(mesh, "make_serve_step")

    def serve_step(params, cache, tokens):
        return api.decode(params, cache, tokens)

    return serve_step


def make_prefill_step(api: ModelApi, mesh=None):
    """prefill(params, batch_inputs) → last-position logits."""
    one_device(mesh, "make_prefill_step")

    def prefill_step(params, inputs):
        return api.prefill(params, inputs)

    return prefill_step
