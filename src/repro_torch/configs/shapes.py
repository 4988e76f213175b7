"""Assigned input shapes (4 per LM arch; 40 cells total).

``decode_*`` / ``long_*`` lower serve_step (one token against a seq_len KV
cache), NOT train_step. long_500k requires sub-quadratic sequence mixing —
it runs only for ssm/hybrid archs (full-attention archs skip it; recorded
per cell in DESIGN.md §7 / EXPERIMENTS.md).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["Shape", "SHAPES", "shape_applicable", "cells"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped). The 40-cell table counts every pair;
    inapplicable cells are recorded as skips, not silently dropped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense-KV decode is not "
                       "sub-quadratic (DESIGN.md §7)")
    return True, ""


def cells(registry: dict[str, ModelConfig]):
    """Every (arch × shape) cell with its applicability verdict."""
    out = []
    for name, cfg in registry.items():
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            out.append((name, shape.name, ok, why))
    return out
