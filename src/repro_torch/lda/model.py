"""LDA configuration and training state (dense and hybrid), as PyTorch
tensors.

``LDAConfig`` keeps the reference's field names and validation
(``src/repro/lda/model.py``) with three changes:

* ``impl`` is ``"torch"`` (plain PyTorch, the reference's ``"xla"``) or
  ``"kernel"`` (the hand-written CUDA kernels, the reference's
  ``"pallas"``), and defaults to ``"kernel"``;
* ``n_topics >= g + 1`` is checked here: the three-branch sampler takes the
  top ``g + 1`` entries of every Ŵ row;
* knobs of paths the port does not have yet (``sampler="two_branch"``)
  raise ``NotImplementedError`` naming the ROADMAP slice that brings them.

``DistConfig`` (the grouped distributed knobs, ``LDAConfig.dist``) is the
reference's, with its validation and the shim that maps the loose
``balance`` knob into it; the distributed backend (``lda/distributed.py``)
rejects what it cannot run, as the reference's does.

The training state carries no PRNG key: iteration ``i`` draws its uniforms
from a ``torch.Generator`` seeded from ``(config.seed, i)``, so
``{topics, iteration}`` alone resumes a run deterministically.

``SparseLDAState`` and ``HybridLayout`` are the hybrid live state of
``format="hybrid"`` (paper §IV): packed sorted D rows, W split into a
dense head and packed tail buckets.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import sparse

__all__ = ["DistConfig", "LDAConfig", "LDAState", "SparseLDAState",
           "HybridLayout", "head_rows_for_coverage", "uniforms_generator"]


def head_rows_for_coverage(row_mass, coverage: float = 0.9) -> int:
    """Smallest H such that rows [0, H) hold >= ``coverage`` of the mass
    (the reference's, bitwise).

    Under the engine's frequency relabeling a row's mass (a word's token
    count: ``W.sum(axis=1)``) does not grow with the row id, so the head
    prefix is the heaviest hot set of its size. The serving tier sizes its
    pinned hot-word cache with it (``repro_torch.serve.cache``). Always at
    least 1; a non-positive total mass gives 1 (nothing to cover).
    """
    if not 0.0 < coverage <= 1.0:
        raise ValueError(f"coverage={coverage} must be in (0, 1]")
    m = np.asarray(row_mass, np.float64).ravel()
    total = float(m.sum())
    if m.size == 0 or total <= 0.0:
        return 1
    cum = np.cumsum(m)
    return int(np.searchsorted(cum, coverage * total, side="left")) + 1


def _unported(knob: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported to repro_torch yet: it arrives with "
        f"ROADMAP.md Queue 1 {slice_}")


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Grouped distributed-training knobs (``LDAConfig.dist``).

    One field instead of loose top-level knobs scattered over LDAConfig:
    everything that only matters when training spans more than one
    device lives here, and ``__post_init__`` is its one validation
    point (the same discipline LDAConfig follows for the single-host
    knobs). The legacy top-level ``balance`` knob keeps working for one
    release through a mapping shim in ``LDAConfig.__post_init__`` that
    warns once per process.

    ``w_sync`` picks how the word-topic matrix W is kept in sync across
    data shards:

      * ``"replicate"`` — the paper's §V-B scheme: every shard holds a
        full W replica, rebuilt each iteration by one delta all-reduce
        (``psum``). Model size is capped by one host's memory.
      * ``"ps"`` — word-sharded parameter server (DESIGN.md SS15): each
        owner holds one contiguous word-range of W; workers pull the
        page of rows their current token sub-shard touches, push int32
        delta blocks back, and a stale-synchronous clock bounds how far
        any worker may run ahead. ``staleness=0`` is bitwise-equal to
        the replicated path.
    """

    mesh_shape: tuple = ()        # (("data", 4), ("model", 2)); () = engine
                                  # default (all devices on the data axis)
    balance: str = "none"         # "none" | "tiles" (paper §V-A at shard
                                  # granularity)
    w_sync: str = "replicate"     # "replicate" | "ps"
    staleness: int = 0            # SSP bound: how many rounds a worker may
                                  # run ahead of the slowest (w_sync="ps")
    owner_layout: str = "rows"    # owner word-ranges: "rows" (equal row
                                  # counts) | "mass" (equal token mass)
    n_owners: int | None = None   # None = one owner per data shard

    def __post_init__(self) -> None:
        if self.w_sync not in ("replicate", "ps"):
            raise ValueError(
                f"unknown w_sync {self.w_sync!r}: expected 'replicate' "
                "(the paper's §V-B full-replica delta all-reduce) or 'ps' "
                "(word-sharded parameter server, DESIGN.md SS15)")
        if self.balance not in ("none", "tiles"):
            raise ValueError(
                f"unknown balance {self.balance!r}: valid options are "
                "'none' or 'tiles' (hierarchical tile-scheduled workload "
                "balancing, paper SSV-A / DESIGN.md SS9)")
        if self.staleness < 0:
            raise ValueError(
                f"staleness={self.staleness} must be >= 0: it bounds how "
                "many commit rounds a worker may run ahead (0 = bulk-"
                "synchronous, bitwise-equal to w_sync='replicate')")
        if self.staleness > 0 and self.w_sync != "ps":
            raise ValueError(
                f"staleness={self.staleness} needs w_sync='ps': the "
                "replicated path is bulk-synchronous by construction "
                "(every iteration ends in one all-reduce)")
        if self.owner_layout not in ("rows", "mass"):
            raise ValueError(
                f"unknown owner_layout {self.owner_layout!r}: expected "
                "'rows' (equal word-row counts per owner) or 'mass' "
                "(equal token mass per owner)")
        if self.n_owners is not None and self.n_owners < 1:
            raise ValueError(
                f"n_owners={self.n_owners} must be >= 1 (or None for one "
                "owner per data shard)")
        if self.w_sync != "ps" and self.n_owners is not None:
            raise ValueError(
                f"n_owners={self.n_owners} is only consumed by "
                "w_sync='ps' (owner word-ranges exist only on the "
                "parameter-server path)")
        if self.mesh_shape:
            for entry in self.mesh_shape:
                if (not isinstance(entry, tuple) or len(entry) != 2
                        or not isinstance(entry[0], str)
                        or int(entry[1]) < 1):
                    raise ValueError(
                        f"mesh_shape entry {entry!r} must be an "
                        "(axis_name, extent>=1) pair, e.g. "
                        "(('data', 4), ('model', 1))")
            names = [a for a, _ in self.mesh_shape]
            if "model" not in names:
                raise ValueError(
                    f"mesh_shape axes {names} lack a 'model' axis: the "
                    "distributed trainer needs one (size 1 reproduces "
                    "the paper's pure data-parallel scheme)")


_LOOSE_DIST_KNOB_WARNED = False


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    n_topics: int
    alpha: float | None = None       # paper: 50/K when None
    beta: float = 0.01               # paper SS II-B
    sampler: str = "three_branch"    # ported: "three_branch", "warp"
    impl: str = "kernel"             # "torch" | "kernel"
    g: int = 2                       # Eq 10 tail-bound terms (paper uses 2)
    mh_cycles: int = 2               # warp: MH proposal cycles per token
    tile_size: int = 8192            # token tile and pad multiple
    format: str = "dense"            # "dense" | "hybrid"
    tail_sampler: str = "exact"      # hybrid tail: "exact" | "sparse"
    balance: str = "none"            # "none" | "tiles"
    d_capacity: int | None = None    # hybrid D row slots; None = bound
    survivor_capacity: int | None = None  # phase-2 chunk size; None=planned
    dense_word_threshold: int | None = None  # hybrid head; None = K
    fused: bool = False              # route run() through train/lda_step.py
    corpus_residency: str = "full"   # "full" | "streamed" | "auto" | "disk"
    corpus_path: str | None = None   # CorpusStore directory (disk residency)
    stream_shards: int | None = None  # epoch shards when streamed; None=auto
    device_budget_bytes: int | None = None  # residency budget; None=card's
    selfcheck: bool = False          # count invariant tripwires
    # prefetch deadline; None=off. It and the worker's retries cover the
    # shards a pass prefetches: the first shard of each pass (every epoch's
    # first, and with checkpoint_shards=k every k-th) loads inline, as the
    # reference loads it, so a fault there goes straight to the caller
    stream_watchdog_seconds: float | None = None
    seed: int = 0
    eval_every: int = 10
    dist: DistConfig | None = None   # grouped distributed knobs; None =
                                     # synthesized from the loose top-level
                                     # knobs (deprecated, warns once)

    def __post_init__(self) -> None:
        # -- grouped-dist shim (the reference's): ``dist`` is authoritative;
        # the loose top-level ``balance`` knob maps into it and warns once,
        # and the top-level field is kept in sync for its readers
        if self.dist is None:
            if self.balance != "none":
                global _LOOSE_DIST_KNOB_WARNED
                if not _LOOSE_DIST_KNOB_WARNED:
                    _LOOSE_DIST_KNOB_WARNED = True
                    warnings.warn(
                        "the top-level LDAConfig.balance knob is moving "
                        "into the grouped LDAConfig.dist field: pass "
                        "dist=DistConfig(balance=...) instead (the loose "
                        "knob keeps working for one release)",
                        DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "dist",
                               DistConfig(balance=self.balance))
        else:
            if not isinstance(self.dist, DistConfig):
                raise ValueError(
                    f"dist={self.dist!r} must be a DistConfig (or None "
                    "to synthesize one from the loose top-level knobs)")
            if self.balance != "none" and self.balance != self.dist.balance:
                raise ValueError(
                    f"balance={self.balance!r} conflicts with "
                    f"dist.balance={self.dist.balance!r}: set it in "
                    "DistConfig only (the top-level knob is a deprecated "
                    "alias)")
            object.__setattr__(self, "balance", self.dist.balance)
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
            raise ValueError(
                f"mh_cycles={self.mh_cycles} must be >= 1: each cycle of "
                "the warp sampler issues one doc and one word proposal")
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
                "expected 'full' (token list on the device), 'streamed' "
                "(epoch shards streamed through the device), 'auto' "
                "(streamed iff the token bytes exceed the device budget), "
                "or 'disk' (a CorpusStore, W paged by shard)")
        # -- what the warp engine cannot run, as in the reference --------
        if self.sampler == "warp" and self.corpus_residency in ("streamed",
                                                                "disk"):
            raise ValueError(
                f"sampler='warp' does not support corpus_residency="
                f"{self.corpus_residency!r}: the MH doc proposal gathers "
                "topics of arbitrary tokens of the same document, which "
                "breaks the epoch-shard locality streaming is built on. Use "
                "corpus_residency='full', or sampler='three_branch' for "
                "streamed training")
        if self.corpus_residency == "disk" and self.corpus_path is None:
            raise ValueError(
                "corpus_residency='disk' needs corpus_path: point it at a "
                "CorpusStore directory (write one with "
                "ShardedCorpus.to_store(path))")
        if self.corpus_path is not None \
                and self.corpus_residency not in ("disk", "auto"):
            raise ValueError(
                f"corpus_path={self.corpus_path!r} is only read by "
                "corpus_residency='disk' (or 'auto', which resolves to "
                f"'disk' when a path is set), got {self.corpus_residency!r}"
                ": set both or neither, so a config never trains from "
                "another corpus than the one named")
        if self.stream_shards is not None and self.stream_shards < 2:
            raise ValueError(
                f"stream_shards={self.stream_shards} must be >= 2 (or None "
                "for the budget-derived count): streaming needs at least "
                "a resident shard and a prefetched shard")
        if self.corpus_path is not None and self.stream_shards is not None:
            raise ValueError(
                f"stream_shards={self.stream_shards} conflicts with "
                "disk-native residency (corpus_path set): the shard grid "
                "is fixed by the CorpusStore manifest — leave "
                "stream_shards None (re-shard by rewriting the store)")
        if self.stream_watchdog_seconds is not None \
                and self.stream_watchdog_seconds <= 0:
            raise ValueError(
                f"stream_watchdog_seconds={self.stream_watchdog_seconds} "
                "must be > 0 (or None to wait on prefetch indefinitely)")
        # -- paths of later slices --------------------------------------
        if self.sampler == "two_branch":
            raise _unported("sampler='two_branch'", "#2 (sample_two_branch)")

    @property
    def alpha_(self) -> float:
        return 50.0 / self.n_topics if self.alpha is None else self.alpha

    @property
    def dense_threshold_(self) -> int:
        # Paper heuristic (§IV-B): a word with >= K tokens may touch every
        # topic, so sparse storage cannot beat dense for it.
        return self.n_topics if self.dense_word_threshold is None else \
            self.dense_word_threshold


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
        """Padded ``topics`` (a host copy) and the iteration."""
        return {"topics": self.topics.cpu().numpy().copy(),
                "iteration": int(self.iteration)}

    def nbytes(self) -> int:
        """Live count-state bytes (D + W buffers)."""
        return int(self.D.numel() + self.W.numel()) * 4


class SparseLDAState(NamedTuple):
    """Training state, hybrid sparse layout, on one device.

    D rows are packed sorted ELL (topic<<16 | count per slot); W splits
    into a dense head (frequent words) and packed tail buckets. The Ŵ
    column sum rides along, and ``overflow`` counts the nonzeros a repack
    could not place: 0 by construction, since ``HybridLayout`` sizes every
    row at its nnz upper bound.
    """
    topics: torch.Tensor               # (N,) int32
    D: torch.Tensor                    # (M, L_d) int32 packed
    W_head: torch.Tensor               # (V_dense, K) int32 dense head
    W_tail: tuple[torch.Tensor, ...]   # packed buckets, halving capacity
    colsum: torch.Tensor               # (K,) int32 == Σ_v W[v][k]
    overflow: torch.Tensor             # () int32 dropped-nonzero tripwire
    iteration: int

    def host_payload(self) -> dict[str, Any]:
        """Padded ``topics`` (a host copy) and the iteration."""
        return {"topics": self.topics.cpu().numpy().copy(),
                "iteration": int(self.iteration)}

    def nbytes(self) -> int:
        """Live count-state bytes (packed D + hybrid W + colsum)."""
        total = self.D.numel() + self.W_head.numel() + self.colsum.numel()
        total += sum(b.numel() for b in self.W_tail)
        return int(total) * 4


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """Static shape plan for the hybrid live state (built once per corpus).

    Capacities are row-nnz upper bounds: a D row holds at most
    min(doc_len, K) distinct topics and a tail W row at most
    min(token_count, K), so no repack can overflow; a pinned
    ``d_capacity`` below the bound is rejected at build.
    """
    n_topics: int
    n_docs: int
    n_words: int
    d_capacity: int                   # packed D row slots
    v_dense: int                      # words [0, v_dense) keep dense rows
    tail_starts: tuple[int, ...]      # first word id of each tail bucket
    tail_caps: tuple[int, ...]        # slots per row, halving per bucket

    @classmethod
    def build(cls, corpus, config: LDAConfig) -> "HybridLayout":
        counts = np.asarray(corpus.word_token_counts)
        if counts.size and not np.all(np.diff(counts) <= 0):
            raise ValueError(
                "format='hybrid' requires a frequency-relabeled corpus "
                "(word token counts non-increasing): call "
                "corpus.relabel_by_frequency before building the trainer")
        k = config.n_topics
        d_bound = int(min(max(int(corpus.doc_lengths.max(initial=1)), 1), k))
        if config.d_capacity is None:
            d_cap = d_bound
        else:
            d_cap = int(config.d_capacity)
            if d_cap < d_bound:
                raise ValueError(
                    f"d_capacity={d_cap} is below the D row-nnz upper bound "
                    f"min(max_doc_len, K)={d_bound}; such rows would "
                    "overflow their ELL slots and break bit-exactness. "
                    "Raise d_capacity (or leave it None for the auto bound)")
            d_cap = min(d_cap, k)
        thr = max(int(config.dense_threshold_), 1)
        v_dense = int(np.searchsorted(-counts, -thr, side="right"))
        tail_upper = np.minimum(counts[v_dense:], k)
        starts: list[int] = []
        caps: list[int] = []
        if len(tail_upper):
            plans = sparse.bucket_plan(tail_upper,
                                       max_capacity=int(min(thr, k)))
            for (s, _e, cap) in plans:
                starts.append(v_dense + s)
                caps.append(int(min(cap, k)))
        return cls(n_topics=k, n_docs=corpus.n_docs, n_words=corpus.n_words,
                   d_capacity=d_cap, v_dense=v_dense,
                   tail_starts=tuple(starts), tail_caps=tuple(caps))

    def tail_ranges(self):
        """(start, end, capacity) of each tail bucket."""
        ends = self.tail_starts[1:] + (self.n_words,)
        return list(zip(self.tail_starts, ends, self.tail_caps))

    # -- conversions (dense <-> hybrid) ------------------------------------

    def pack_d(self, D: torch.Tensor) -> torch.Tensor:
        """(M, K) -> (M, L) packed, sorted slots."""
        return sparse.pack_rows_sorted(D, self.d_capacity)[0]

    def split_w(self, W: torch.Tensor):
        """Dense (V, K) W -> (dense head, packed sorted tail buckets)."""
        head = W[:self.v_dense].clone()
        tail = tuple(sparse.pack_rows_sorted(W[s:e], cap)[0]
                     for s, e, cap in self.tail_ranges())
        return head, tail

    def densify_w(self, w_head: torch.Tensor,
                  w_tail: tuple[torch.Tensor, ...]) -> torch.Tensor:
        """(head, tail buckets) -> dense (V, K) int32, exact."""
        if not w_tail:
            return w_head.clone()
        out = torch.empty((self.n_words, self.n_topics), dtype=torch.int32,
                          device=w_head.device)
        out[:self.v_dense] = w_head
        for (s, e, _cap), b in zip(self.tail_ranges(), w_tail):
            out[s:e] = sparse.densify_rows_sorted(b, self.n_topics)
        return out

    def to_sparse(self, state: LDAState) -> SparseLDAState:
        """Dense state -> hybrid state, in fresh buffers."""
        w_head, w_tail = self.split_w(state.W)
        return SparseLDAState(
            topics=state.topics.clone(), D=self.pack_d(state.D),
            W_head=w_head, W_tail=w_tail,
            colsum=state.W.sum(dim=0, dtype=torch.int32),
            overflow=torch.zeros((), dtype=torch.int32,
                                 device=state.D.device),
            iteration=int(state.iteration))

    def to_dense(self, state: SparseLDAState) -> LDAState:
        return LDAState(
            topics=state.topics,
            D=sparse.densify_rows_sorted(state.D, self.n_topics),
            W=self.densify_w(state.W_head, state.W_tail),
            iteration=int(state.iteration))


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
