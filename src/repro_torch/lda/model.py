"""LDA configuration and dense training state, as PyTorch tensors.

``LDAConfig`` keeps the reference's field names and validation
(``src/repro/lda/model.py``) with three changes:

* ``impl`` is ``"torch"`` (plain PyTorch, the reference's ``"xla"``) or
  ``"kernel"`` (the hand-written CUDA kernels, the reference's
  ``"pallas"``), and defaults to ``"kernel"``;
* ``n_topics >= g + 1`` is checked here: the three-branch sampler takes the
  top ``g + 1`` entries of every Ŵ row;
* knobs of paths the port does not have yet raise ``NotImplementedError``
  naming the ROADMAP slice that brings them.

The training state carries no PRNG key: iteration ``i`` draws its uniforms
from a ``torch.Generator`` seeded from ``(config.seed, i)``, so
``{topics, iteration}`` alone resumes a run deterministically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["LDAConfig", "LDAState", "uniforms_generator"]


def _unported(knob: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported to repro_torch yet: it arrives with "
        f"ROADMAP.md Queue 1 {slice_}")


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    n_topics: int
    alpha: float | None = None       # paper: 50/K when None
    beta: float = 0.01               # paper SS II-B
    sampler: str = "three_branch"    # ported: "three_branch"
    impl: str = "kernel"             # "torch" | "kernel"
    g: int = 2                       # Eq 10 tail-bound terms (paper uses 2)
    mh_cycles: int = 2               # warp sampler knob (not ported)
    tile_size: int = 8192            # token tile and pad multiple
    format: str = "dense"            # ported: "dense"
    tail_sampler: str = "exact"      # hybrid knob (not ported)
    balance: str = "none"            # ported: "none"
    d_capacity: int | None = None    # hybrid knob (not ported)
    survivor_capacity: int | None = None  # phase-2 chunk size; None=planned
    dense_word_threshold: int | None = None  # hybrid knob (not ported)
    fused: bool = False              # route run() through train/lda_step.py
    corpus_residency: str = "full"   # ported: "full"
    corpus_path: str | None = None   # disk residency (not ported)
    stream_shards: int | None = None  # streamed residency (not ported)
    device_budget_bytes: int | None = None  # residency budget (not ported)
    selfcheck: bool = False          # invariant tripwires (not ported)
    stream_watchdog_seconds: float | None = None  # streaming (not ported)
    seed: int = 0
    eval_every: int = 10
    dist: Any = None                 # distributed knobs (not ported)

    def __post_init__(self) -> None:
        if self.n_topics < 1:
            raise ValueError(f"n_topics={self.n_topics} must be >= 1")
        if self.sampler not in ("two_branch", "three_branch", "warp"):
            raise ValueError(
                f"unknown sampler {self.sampler!r}: valid options are "
                "'two_branch', 'three_branch', or 'warp'")
        if self.impl not in ("torch", "kernel"):
            raise ValueError(
                f"unknown impl {self.impl!r}: valid options are 'torch' "
                "(plain PyTorch) or 'kernel' (hand-written CUDA kernels)")
        if self.format not in ("dense", "hybrid"):
            raise ValueError(f"unknown state format {self.format!r}: "
                             "expected 'dense' or 'hybrid'")
        if self.tail_sampler not in ("exact", "sparse"):
            raise ValueError(f"unknown tail_sampler {self.tail_sampler!r}: "
                             "expected 'exact' or 'sparse'")
        if self.balance not in ("none", "tiles"):
            raise ValueError(
                f"unknown balance {self.balance!r}: valid options are "
                "'none' or 'tiles'")
        if self.g < 1:
            raise ValueError(f"g={self.g} must be >= 1 (paper uses 2)")
        if self.sampler == "three_branch" and self.n_topics < self.g + 1:
            raise ValueError(
                f"n_topics={self.n_topics} must be >= g+1={self.g + 1}: the "
                "three-branch sampler reads the top g+1 entries of every Ŵ "
                "row")
        if self.mh_cycles < 1:
            raise ValueError(f"mh_cycles={self.mh_cycles} must be >= 1")
        if self.tile_size < 1:
            raise ValueError(f"tile_size={self.tile_size} must be >= 1")
        if self.eval_every < 1:
            raise ValueError(f"eval_every={self.eval_every} must be >= 1")
        if self.alpha is not None and self.alpha <= 0:
            raise ValueError(f"alpha={self.alpha} must be positive "
                             "(or None for the paper's 50/K)")
        if self.beta <= 0:
            raise ValueError(f"beta={self.beta} must be positive")
        for knob in ("d_capacity", "survivor_capacity",
                     "dense_word_threshold", "device_budget_bytes"):
            v = getattr(self, knob)
            if v is not None and v < 1:
                raise ValueError(f"{knob}={v} must be >= 1 (or None for auto)")
        if self.corpus_residency not in ("full", "streamed", "auto", "disk"):
            raise ValueError(
                f"unknown corpus_residency {self.corpus_residency!r}: "
                "expected 'full', 'streamed', 'auto', or 'disk'")
        # -- paths of later slices --------------------------------------
        if self.sampler == "two_branch":
            raise _unported("sampler='two_branch'", "#2 (sample_two_branch)")
        if self.format == "hybrid":
            raise _unported("format='hybrid'", "#7 (hybrid sparse state)")
        if self.balance == "tiles":
            raise _unported("balance='tiles'", "#6 (tile balancing)")
        if self.sampler == "warp":
            raise _unported("sampler='warp'", "#8 (warp MH engine)")
        if self.corpus_residency != "full" or self.corpus_path is not None \
                or self.stream_shards is not None \
                or self.device_budget_bytes is not None \
                or self.stream_watchdog_seconds is not None:
            raise _unported(
                f"corpus_residency={self.corpus_residency!r} and its knobs",
                "#10 (streaming and disk residency)")
        if self.selfcheck:
            raise _unported("selfcheck=True", "#11 (failure model)")
        if self.dist is not None:
            raise _unported("dist", "#12 (multi-GPU and parameter server)")

    @property
    def alpha_(self) -> float:
        return 50.0 / self.n_topics if self.alpha is None else self.alpha


class LDAState(NamedTuple):
    """Training state, dense layout, on one device.

    D and W are *derived* from (corpus, topics): ``lda/convert.py`` and the
    trainer rebuild them from the topics alone.
    """
    topics: torch.Tensor   # (N,) int32, padded token order
    D: torch.Tensor        # (M, K) int32
    W: torch.Tensor        # (V, K) int32
    iteration: int

    def host_payload(self) -> dict[str, Any]:
        return {"topics": self.topics.cpu().numpy(),
                "iteration": int(self.iteration)}

    def nbytes(self) -> int:
        """Live count-state bytes (D + W buffers)."""
        return int(self.D.numel() + self.W.numel()) * 4


def uniforms_generator(seed: int, stream: int,
                       device: torch.device) -> torch.Generator:
    """The generator of one random stream of a run.

    Stream 0 draws the initial topics; stream ``i + 1`` draws the uniforms
    of iteration ``i``. NumPy's SeedSequence mixes ``(seed, stream)`` into
    one 63-bit seed, so neighbouring streams are unrelated.
    """
    mixed = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(mixed) >> 1)
    return g
