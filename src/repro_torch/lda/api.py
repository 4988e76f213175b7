"""One front door for LDA: ``LDAEngine`` on one device or a process
mesh, and the serving artifact ``FrozenLDAModel``.

Port of ``src/repro/lda/api.py``.

``LDAEngine``
    Owns corpus prep (documents -> ``Corpus``, relabel by frequency, keep
    the ``word_map``), builds the trainer on the training device, and
    accumulates the history of every ``fit`` call. With
    ``checkpoint_dir=`` (or ``checkpoint_manager=``) it saves the
    canonical payload (``lda/convert.py``) through ``save()`` and every
    ``fit(checkpoint_every=)`` boundary, and ``resume()`` (or the first
    ``fit``) restores the newest checkpoint — one written by either
    package. ``engine.state`` stays a dense ``LDAState`` whatever the
    format, as in the reference: a hybrid run packs it on entry to ``fit``
    and densifies it on the way out, so ``export()`` works after any
    configuration.

``FrozenLDAModel``
    The serving artifact: frozen topic-word counts W plus hyperparameters.
    Ŵ and the per-word top-(g+1) stats are computed once, when the model
    is frozen, and live on the model's device with every fold-in tensor.
    ``transform(docs)`` is the batched fold-in Gibbs sampler: per sweep,
    the phase-1 skip test from the frozen stats, the survivors drawn by
    the ``sample_fused`` kernel (``sample_fused_rows``), skipped tokens at
    K1, then the batch's doc-topic counts rebuilt by the ``histogram``
    kernel's sorted route over the doc-major grid. Where the reference
    compiles a batch into one donated dispatch, PyTorch runs it eagerly:
    the survivor count is read back once a sweep.

Residency (``LDAConfig.corpus_residency``): "streamed" (or "auto" past
the card's budget) keeps the corpus on the host and streams it through
the card by epoch shard; "disk" trains from the ``CorpusStore`` at
``corpus_path`` (``LDAEngine(None, LDAConfig(corpus_residency="disk",
corpus_path=path))``: the store holds the prepped corpus) with W paged by
shard as well. The engine's state is then a ``StreamState`` where the
trainer keeps one (disk, or mid-epoch), and ``score``, ``host_payload``,
``save``, ``export`` and ``top_words`` go through the stream.

Every entry point runs on the CUDA card unless given ``device="cpu"``
(then the kernel wrappers take their plain twins); with no card and no
explicit CPU it raises. The paper's configuration runs through the same
door::

    LDAEngine(corpus, LDAConfig(n_topics=1000, format="hybrid",
                                tail_sampler="sparse", balance="tiles",
                                fused=True)).fit(5)

Randomness of fold-in: stream ``(seed, 0)`` of
``lda.model.uniforms_generator`` draws the initial topics and stream
``(seed, s + 1)`` the uniforms of sweep ``s``, so ``n_sweeps=s`` is
bitwise the first ``s`` sweeps of a longer run (the reference's
prefix-stable ``fold_in(ksweep, s)``; the draws themselves differ).

Supervision (``fit(supervise=SupervisePolicy(...))`` or ``True``): the
reference's failure model. A restartable fault (``SupervisePolicy.
restartable``: an injected one from ``runtime/chaos.py``, a tripped
``LDAConfig(selfcheck=True)`` invariant, a shard's crc32, a prefetch I/O
error or watchdog, a real CUDA out-of-memory) rebuilds the trainer,
frees the dead attempt's device memory, and restores the newest valid
checkpoint after a bounded backoff; replay is bitwise because counts are
derived from topics and iteration ``i`` draws from ``(seed, i + 1)``. An
out-of-memory fault on the resident path degrades the run once to
``corpus_residency="streamed"``, on the same card. Checkpoints are cut
every ``checkpoint_every`` iterations, or every ``checkpoint_shards``
shards mid-epoch on a streamed or disk trainer (step keys
``it·(S+1)+cursor``, as in the reference, so a supervised directory
restores in either package). The report comes back as
``history["restart_report"]`` and ``engine.restart_report``.

The distributed backend (``backend="distributed"``, or ``"auto"`` in a
default process group of more than one rank): every rank of an
initialized ``torch.distributed`` group builds the same engine over a
``ProcessMesh`` (``runtime/sharding.py``) and trains its data shard
through ``lda/distributed.py::DistLDATrainer``; with a model axis of 1 it
is bitwise the single-device engine. Under ``torchrun``::

    torch.distributed.init_process_group("nccl")
    torch.cuda.set_device(local_rank)
    LDAEngine(corpus, LDAConfig(n_topics=1000, fused=True),
              backend="distributed").fit(5)

With ``corpus_residency="streamed"`` each rank streams its tokens
through the card sub-shard by sub-shard, bitwise its resident run.

The parameter-server backend (``DistConfig(w_sync="ps")``,
``lda/distributed.py::PSDistTrainer``) runs every worker of its grid
(``DistConfig.mesh_shape``, the shape of ``mesh=``, or one worker a
visible card) in the calling process, one after the other on the
engine's device, with W in the host-side server; it needs no process
group and refuses a default group of more than one rank. At
``staleness=0`` it is bitwise the single-device engine, and it takes
``fit(supervise=...)``, with ``SupervisePolicy(checkpoint_shards=k)``
cutting mid-round ``ps_*`` checkpoints (step keys ``it·(R+1)+cursor``).

On the replicated distributed backend ``fit(supervise=...)`` runs on
every rank with the same arguments. A fault on any rank reaches every
rank before the next collective (``runtime/fault.py``: rank-agreed
faults), so every rank restarts together: rank 0 picks the newest valid
checkpoint and every rank restores it; an out-of-memory fault on any
rank degrades every rank to streamed residency; ``checkpoint_shards``
cuts mid-epoch checkpoints of the streamed replicated trainer. Every rank
ends with the same history (its ``tokens_per_sec`` aside, each rank's own
clock) and the same ``restart_report`` (its wall times aside; the
straggler test reads the slowest rank's seconds, so its steps agree).

Serving (``repro_torch.serve``): ``subscribe(fn)`` delivers a
``ServingSnapshot`` at every publish point (chunk boundaries of ``fit``
and a final one, every shard group of a shard-wise supervised fit, every
``publish_serving()``); ``serve.attach(engine, service)`` wires them into
a running ``LDAService``. On the replicated backend every rank publishes
(the W replica; gathered over ``model`` when the topics are split, so
every rank subscribes alike or none does).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
import traceback
import warnings
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ps_payload import PS_PAYLOAD_PREFIX
from repro_torch.core import esca, llpt, three_branch
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels.sample_fused import sample_fused_rows
from repro_torch.lda.convert import (canonical_topics, stream_payload_keys,
                                     to_canonical)
from repro_torch.lda.corpus import Corpus, from_documents, relabel_by_frequency
from repro_torch.lda.distributed import DistLDATrainer, PSDistTrainer
from repro_torch.lda.model import LDAConfig, uniforms_generator
from repro_torch.lda.trainer import LDATrainer, run_boundary_chunked
from repro_torch.runtime import chaos
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.fault import (FAULT_FATAL, RankAbort, RankFault,
                                       RestartReport, StepTimer,
                                       SupervisePolicy, fault_vote,
                                       is_oom_error, supervised_loop)
from repro_torch.runtime.sharding import ProcessMesh
from repro_torch.train.lda_step import (StreamState, draw_uniforms,
                                        resolves_to_disk)

__all__ = ["LDAEngine", "FrozenLDAModel", "FoldInBatch", "FoldInResult",
           "RestartReport", "SupervisePolicy", "frozen_w_hat"]


# ---------------------------------------------------------------------------
# serving: the frozen artifact + the batched fold-in sampler
# ---------------------------------------------------------------------------

class FoldInBatch(NamedTuple):
    """Padded token batch on the model's device, built by
    ``FrozenLDAModel.prepare_batch``: a (B, L) grid flattened doc-major,
    B and L bucketed to powers of two; pad slots carry mask 0 and never
    touch θ or the LLPT."""
    word_ids: torch.Tensor     # (B*L,) int32
    doc_ids: torch.Tensor      # (B*L,) int32 — row index, sorted
    mask: torch.Tensor         # (B*L,) int32 — 1 = real token
    n_docs: int                # B
    doc_lens: np.ndarray       # (B_real,) host int64
    n_real_docs: int           # rows of θ that are real docs


def _next_pow2(n: int, floor: int = 16) -> int:
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


class FoldInResult(NamedTuple):
    """One fold-in's host-side readout."""
    theta: np.ndarray          # (B, K) doc-topic distributions
    llpt: float                # held-out log-likelihood per token (Eq 5)
    frac_skipped: np.ndarray   # (n_sweeps,) phase-1 skip fraction per sweep


def _top_words(W: np.ndarray, word_map: np.ndarray | None,
               k: int) -> np.ndarray:
    """(K, k) most probable word ids per topic, in the ORIGINAL vocab.

    When the engine frequency-relabeled the corpus, W's rows live in
    relabeled space; the inverse map restores user-facing ids.
    """
    top = np.argsort(-W, axis=0, kind="stable")[:k].T        # (K, k)
    if word_map is not None:
        V = W.shape[0]
        new_to_old = np.empty(V, np.int64)
        new_to_old[np.asarray(word_map, np.int64)] = np.arange(V)
        top = new_to_old[top]
    return top


def frozen_w_hat(W_rows: np.ndarray, colsum: np.ndarray, n_words: int,
                 beta: float) -> np.ndarray:
    """Ŵ of rows of a frozen W with the reference's float32 operations in
    NumPy, ``(W + β) / (colsum + V·β)``: ``colsum`` is the int64 column sum
    of all ``n_words`` = V rows. Row-wise, so a slice of rows gives that
    slice of the full Ŵ, bitwise."""
    return (np.asarray(W_rows).astype(np.float32) + np.float32(beta)) \
        / (colsum.astype(np.float32) + np.float32(n_words * beta))


@dataclasses.dataclass(frozen=True, eq=False)
class FrozenLDAModel:
    """Frozen LDA model for serving: W + hyperparameters, read-only.

    ``phi[v][k] = (W[v][k]+β)/(colsum[k]+V·β)`` (== training's Ŵ) is fixed,
    so everything per-word is computed at freeze time, on ``device``
    (``None``: the CUDA card), and fold-in pays only per-token work.
    ``W`` stays a host int32 array. ``word_map`` carries the engine's
    frequency relabeling (old id -> model id); ``transform``/``score``
    take documents in the ORIGINAL vocabulary and remap them.
    """
    W: np.ndarray                  # (V, K) int32 frozen topic-word counts
    alpha: float
    beta: float
    g: int = 2
    word_map: np.ndarray | None = None   # (V,) int64 old->model ids
    tile_size: int = 8192
    device: Any = None

    def __post_init__(self):
        W = np.asarray(self.W, np.int32)
        if W.ndim != 2:
            raise ValueError(f"W must be (V, K), got shape {W.shape}")
        dev = resolve_device(self.device)
        object.__setattr__(self, "W", W)
        object.__setattr__(self, "device", dev)
        # Ŵ exactly as the reference computes it (colsum summed in int64,
        # then cast), so Ŵ and its top-(g+1) stats, ties included, agree
        w_hat = torch.from_numpy(frozen_w_hat(
            W, W.sum(axis=0, dtype=np.int64), W.shape[0],
            self.beta)).to(dev)
        stats = three_branch.word_stats(w_hat, g=self.g,
                                        alpha=float(self.alpha))
        object.__setattr__(self, "_w_hat", w_hat)
        object.__setattr__(self, "_stats", stats)
        # the fused kernel's per-word K1, a1 and Q'
        object.__setattr__(self, "_k1_a1_q", tuple(
            x.contiguous() for x in (stats.k[:, 0], stats.a[:, 0],
                                     stats.q_prime)))

    # -- shape ---------------------------------------------------------------

    @property
    def n_words(self) -> int:
        return int(self.W.shape[0])

    @property
    def n_topics(self) -> int:
        return int(self.W.shape[1])

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_state(cls, state, config: LDAConfig,
                   word_map: np.ndarray | None = None,
                   device=None) -> "FrozenLDAModel":
        """Freeze a dense training state (LDAState or anything with .W)."""
        W = state.W.cpu().numpy() if isinstance(state.W, torch.Tensor) \
            else state.W
        return cls(W=np.array(W, np.int32), alpha=config.alpha_,
                   beta=config.beta, g=config.g, word_map=word_map,
                   tile_size=config.tile_size, device=device)

    @classmethod
    def from_payload(cls, payload: dict[str, Any], corpus: Corpus,
                     config: LDAConfig, word_map: np.ndarray | None = None,
                     device=None) -> "FrozenLDAModel":
        """Freeze straight from a canonical checkpoint payload.

        W is derived state: it is rebuilt from (corpus, topics_global) by
        one host histogram, so any checkpoint either package wrote can be
        served.

        Mid-epoch STREAMED payloads are rejected: their ``topics_global``
        is rewound to the epoch start, so the histogram here would
        silently serve a model up to one epoch older than the checkpoint's
        iteration claims.
        """
        if payload.get("stream_cursor") is not None:
            raise ValueError(
                "from_payload got a MID-EPOCH streamed checkpoint "
                f"(stream_cursor={int(payload['stream_cursor'])}): its "
                "topics_global is rewound to the epoch start, so freezing "
                "it would serve stale counts. Resume and finish the epoch "
                "first (engine.restore(payload); engine.fit(1)) and "
                "freeze a boundary state with engine.export(), or publish "
                "a bounded-staleness view through engine.publish_serving()"
                " instead")
        topics = canonical_topics(payload, corpus.n_tokens).astype(np.int64)
        K = config.n_topics
        if topics.size and (topics.min() < 0 or topics.max() >= K):
            raise ValueError(f"checkpoint topics lie outside [0, {K})")
        W = np.bincount(np.asarray(corpus.word_ids, np.int64) * K + topics,
                        minlength=corpus.n_words * K)
        return cls(W=W.reshape(corpus.n_words, K).astype(np.int32),
                   alpha=config.alpha_, beta=config.beta, g=config.g,
                   word_map=word_map, tile_size=config.tile_size,
                   device=device)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """The reference's ``.npz`` keys and dtypes: either package loads
        the file."""
        arrs = {"W": self.W,
                "alpha": np.float64(self.alpha),
                "beta": np.float64(self.beta),
                "g": np.int64(self.g),
                "tile_size": np.int64(self.tile_size)}
        if self.word_map is not None:
            arrs["word_map"] = np.asarray(self.word_map, np.int64)
        with open(path, "wb") as f:
            np.savez(f, **arrs)
        return path

    @classmethod
    def load(cls, path: str, device=None) -> "FrozenLDAModel":
        with np.load(path) as z:
            wm = z["word_map"] if "word_map" in z.files else None
            return cls(W=z["W"], alpha=float(z["alpha"]),
                       beta=float(z["beta"]), g=int(z["g"]),
                       word_map=wm, tile_size=int(z["tile_size"]),
                       device=device)

    # -- batching ------------------------------------------------------------

    def prepare_batch(self, docs: Sequence[Sequence[int]]) -> FoldInBatch:
        """Pad docs to a (B, L) grid on the model's device.

        B is the next power of two of the doc count (floor 8), L that of
        the longest doc (floor 16): the reference's grid, bitwise. Pad
        slots use word 0 with mask 0. Word ids arrive in the ORIGINAL
        vocabulary and are remapped through ``word_map``.
        """
        if not len(docs):
            raise ValueError("prepare_batch needs at least one document")
        arrs = [np.asarray(d, np.int64).ravel() for d in docs]
        for i, a in enumerate(arrs):
            if a.size and (a.min() < 0 or a.max() >= self.n_words):
                raise ValueError(
                    f"doc {i} has word ids outside [0, {self.n_words}): "
                    "documents must use the training vocabulary")
        if self.word_map is not None:
            wm = np.asarray(self.word_map, np.int64)
            arrs = [wm[a] for a in arrs]
        n_real = len(arrs)
        B = _next_pow2(n_real, floor=8)
        lens = np.array([a.size for a in arrs], np.int64)
        L = _next_pow2(int(lens.max(initial=1)))
        wid = np.zeros((B, L), np.int32)
        mask = np.zeros((B, L), np.int32)
        for i, a in enumerate(arrs):
            wid[i, :a.size] = a
            mask[i, :a.size] = 1
        doc_ids = np.repeat(np.arange(B, dtype=np.int32), L)
        dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return FoldInBatch(dev(wid.ravel()), dev(doc_ids),
                           dev(mask.ravel()), B, lens, n_real)

    # -- the fold-in sampler -------------------------------------------------

    def count_plan(self, batch: FoldInBatch):
        """The sorted ``histogram`` route's plan over the batch's
        doc-major grid (rows sorted by construction), built once a batch;
        None where one row of K counters does not fit a block (the
        any-order route then counts)."""
        if not _hist.sorted_route_fits(self.n_topics):
            return None
        return _hist.plan_row_blocks(
            _hist.row_offsets(batch.doc_ids, batch.n_docs), self.n_topics)

    def batch_counts(self, batch: FoldInBatch, topics: torch.Tensor,
                     plan) -> torch.Tensor:
        """(B, K) doc-topic counts of ``topics``, the mask as weights,
        through the ``histogram`` kernel."""
        if plan is None:
            return _hist.histogram(batch.doc_ids, topics, batch.mask,
                                   n_rows=batch.n_docs,
                                   n_topics=self.n_topics)
        return _hist.histogram_sorted(topics, batch.mask, plan)

    def sweep(self, batch: FoldInBatch, u: torch.Tensor,
              topics: torch.Tensor, D: torch.Tensor | None = None,
              plan=None):
        """One fold-in sweep from ``topics`` with uniforms ``u`` (B·L,).

        ESCA semantics, as in training: every token samples from the
        sweep-start counts ``D`` (rebuilt from ``topics`` when not
        given), then D is rebuilt. The phase-1 skip test runs with the
        frozen word stats; the real tokens it does not skip are compacted
        and drawn by ``sample_fused_rows``; the rest take K1 (pad slots
        too: they carry mask 0). Returns (topics, D, skip fraction).
        """
        word, doc, mask = batch.word_ids, batch.doc_ids, batch.mask
        if D is None:
            D = self.batch_counts(batch, topics, plan)
        dec = three_branch.skip_phase(u, word, doc, D, self._stats, g=self.g,
                                      alpha=float(self.alpha))
        real = mask > 0
        new_topics = dec.k1.clone()
        surv = (real & ~dec.skip).nonzero().squeeze(1)
        if surv.numel():
            new_topics[surv] = sample_fused_rows(
                u[surv], doc[surv], word[surv], D, self._w_hat,
                *self._k1_a1_q, alpha=float(self.alpha))[0]
        n_real = torch.clamp(real.sum(), min=1).float()
        frac = (dec.skip & real).sum().float() / n_real
        return new_topics, self.batch_counts(batch, new_topics, plan), frac

    def transform_batch(self, batch: FoldInBatch, seed: int = 0, *,
                        n_sweeps: int = 20):
        """(θ, D, topics, llpt, per-sweep skip fractions) for a prepared
        batch, each a tensor on the model's device."""
        dev, K = self.device, self.n_topics
        n = int(batch.word_ids.shape[0])
        alpha = float(self.alpha)
        plan = self.count_plan(batch)
        topics = esca.init_topics(uniforms_generator(seed, 0, dev), (n,), K)
        D = self.batch_counts(batch, topics, plan)
        skips = torch.zeros(n_sweeps, dtype=torch.float32, device=dev)
        for s in range(n_sweeps):
            topics, D, skips[s] = self.sweep(
                batch, draw_uniforms(seed, s, n, dev), topics, D, plan)
        len_d = D.sum(dim=1, dtype=torch.float32)
        theta = (D.float() + alpha) / (len_d[:, None] + K * alpha)
        # held-out LLPT: Eq 5 with the frozen φ == Ŵ, gathered for the
        # real tokens only (the grid's pad slots can outnumber them)
        real = (batch.mask > 0).nonzero().squeeze(1)
        ll = llpt.token_ll(batch.word_ids[real], batch.doc_ids[real], D,
                           alpha=alpha, phi=self._w_hat,
                           tile_size=self.tile_size)
        return (theta, D, topics, llpt.reduce_ll(ll, batch.mask[real]),
                skips)

    def fold_in(self, docs: Sequence[Sequence[int]], *, n_sweeps: int = 20,
                seed: int = 0) -> FoldInResult:
        """θ AND the held-out LLPT AND skip stats from one pass: the
        single entry point when a caller wants more than one readout."""
        batch = self.prepare_batch(docs)
        theta, _, _, ll, skips = self.transform_batch(batch, seed,
                                                      n_sweeps=n_sweeps)
        # drop the bucketing pad rows (uniform θ, zero tokens)
        return FoldInResult(theta=theta[:batch.n_real_docs].cpu().numpy(),
                            llpt=float(ll), frac_skipped=skips.cpu().numpy())

    def transform(self, docs: Sequence[Sequence[int]], *,
                  n_sweeps: int = 20, seed: int = 0) -> np.ndarray:
        """Fold unseen documents in: (B, K) doc-topic distributions θ,
        θ[d][k] = (D'[d][k]+α)/(len(d)+K·α) after ``n_sweeps`` Gibbs
        sweeps against the frozen φ. Bit-reproducible for a fixed seed on
        one device."""
        return self.fold_in(docs, n_sweeps=n_sweeps, seed=seed).theta

    def score(self, docs: Sequence[Sequence[int]], *, n_sweeps: int = 20,
              seed: int = 0) -> float:
        """Held-out log-likelihood per token (Eq 5) under the frozen φ."""
        return self.fold_in(docs, n_sweeps=n_sweeps, seed=seed).llpt

    # -- introspection -------------------------------------------------------

    def top_words(self, k: int = 10) -> np.ndarray:
        """(K, k) most probable word ids per topic, in the ORIGINAL vocab."""
        return _top_words(self.W, self.word_map, k)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _CanonicalManager:
    """Checkpoint-manager adapter: canonical payloads on disk, the
    trainer's padded ``topics`` in memory. The trainer restores either
    format (``LDATrainer.state_from_payload``), so only a save converts."""

    def __init__(self, inner: CheckpointManager, to_canonical: Callable):
        self.inner = inner
        self._to = to_canonical

    def save(self, step: int, payload: dict[str, Any]) -> str:
        return self.inner.save(step, self._to(payload))

    def restore_latest(self, log_fn=None) -> dict[str, Any] | None:
        return self.inner.restore_latest(log_fn=log_fn)


class _SingleBackend:
    """``LDATrainer`` behind the engine surface (one device: dense, hybrid,
    warp, streamed or disk), its checkpoints canonical on disk."""

    name = "single"
    is_ps = False

    def __init__(self, corpus: Corpus | None, config: LDAConfig, device,
                 manager: CheckpointManager | None):
        trainer = LDATrainer(corpus, config, device=device)
        if manager is not None:
            n_real = trainer.n_real_tokens      # no cycle back to self
            trainer.checkpoint_manager = _CanonicalManager(
                manager, lambda p: to_canonical(p, n_real))
        self.trainer = trainer
        self.config = config
        self.manager = manager
        self.device = trainer.device

    def restore_or_init(self):
        return self.trainer.restore_or_init()

    def state_from_payload(self, payload: dict[str, Any]):
        return self.trainer.state_from_payload(payload)

    def canonical_payload(self, state) -> dict[str, Any]:
        return to_canonical(self.trainer.host_payload(state),
                            self.trainer.n_real_tokens)

    def save(self, step: int, payload: dict[str, Any]) -> str:
        return self.manager.save(step, payload)

    def run(self, n_iters: int, state, log_fn, checkpoint_every,
            on_chunk=None):
        return self.trainer.run(n_iters, state, log_fn, checkpoint_every,
                                on_chunk=on_chunk)

    def restore_latest(self, log_fn=None) -> dict[str, Any] | None:
        return self.manager.restore_latest(log_fn=log_fn)

    def evaluate(self, state) -> float:
        return self.trainer.evaluate(state)

    def dense_W(self, state) -> np.ndarray:
        if isinstance(state, StreamState):
            return self.trainer.fused_pipeline().dense_W(state)
        return np.array(state.W.cpu(), np.int32)

    def serving_W(self, state) -> tuple:
        """``(W, cursor, n_shards)``: a mid-epoch ``StreamState`` gives the
        epoch-start W plus the sampled shards' moves (``serving_counts``),
        every other state its exact W at cursor 0."""
        if isinstance(state, StreamState):
            return self.trainer.fused_pipeline().serving_counts(state)
        return self.dense_W(state), 0, 1

    def live_serving_W(self):
        return self.trainer.live_serving_W()

    def state_nbytes(self, state) -> int:
        if isinstance(state, StreamState):
            return self.trainer.fused_pipeline().nbytes(state)
        if self.trainer.streams:        # a dense state of a streamed run
            pipe = self.trainer.fused_pipeline()
            return pipe.nbytes(pipe.from_lda_state(state))
        if self.config.format == "hybrid":
            return self.trainer.fused_pipeline().from_lda_state(
                state).nbytes()
        return state.nbytes()

    def close(self) -> None:
        self.trainer.close()


def _world_size() -> int:
    """World size of the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _ps_grid(config: LDAConfig, mesh, device) -> dict:
    """The parameter server's worker grid: ``DistConfig.mesh_shape``, the
    shape of ``mesh``, or one worker a visible device of the engine's
    device type (the reference's ``(jax.device_count(), 1)``; the CPU
    counts as one)."""
    if _world_size() > 1:
        raise ValueError(
            "DistConfig(w_sync='ps') runs every parameter-server worker in "
            "one process, one after another on the engine's device, but "
            f"the default process group has {_world_size()} ranks: every "
            "rank would run every worker. Start it in a single process "
            "(no torchrun, or a group of one rank), or use "
            "w_sync='replicate' across the group")
    if config.dist.mesh_shape:
        return {a: int(e) for a, e in config.dist.mesh_shape}
    if mesh is not None:
        return dict(mesh.shape)
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {"data": max(n, 1), "model": 1}


class _DistBackend:
    """The distributed trainers behind the engine surface:
    ``DistLDATrainer``, one rank of the replicated multi-GPU trainer
    (``dist.w_sync="replicate"``), or ``PSDistTrainer``, the parameter
    server's workers in this process (``"ps"``).

    Replicated, every rank of the default process group builds the same
    engine and calls the same methods in the same order: training,
    ``score``, ``host_payload``, ``save``, ``export`` and ``top_words``
    run collectives. Checkpoints are written by rank 0 after every rank
    has assembled the payload, then a barrier; every rank restores.
    """

    name = "distributed"

    def __init__(self, corpus: Corpus, config: LDAConfig, device,
                 manager: CheckpointManager | None, mesh,
                 pad_multiple: int = 1024, process_mesh=None):
        dc = config.dist
        if mesh is not None and dc.mesh_shape:
            raise ValueError(
                "pass mesh= OR DistConfig.mesh_shape, not both: two mesh "
                "specifications with different extents would silently "
                "disagree")
        self.config = config
        self.manager = manager
        self.is_ps = dc.w_sync == "ps"
        self._live = None
        if self.is_ps:
            self.mesh = None
            self.trainer = PSDistTrainer(
                corpus, config, _ps_grid(config, mesh, device),
                pad_multiple=pad_multiple, device=device, _from_engine=True)
        else:
            if process_mesh is not None:       # a rebuild keeps its groups
                mesh = process_mesh
            elif mesh is None:
                if dc.mesh_shape:
                    mesh = ProcessMesh(
                        tuple(int(e) for _, e in dc.mesh_shape),
                        tuple(a for a, _ in dc.mesh_shape))
                else:
                    mesh = ProcessMesh((_world_size(), 1),
                                       ("data", "model"))
            self.mesh = mesh
            self.trainer = DistLDATrainer(corpus, config, mesh,
                                          pad_multiple=pad_multiple,
                                          device=device, _from_engine=True)
        self.device = self.trainer.device

    def restore_or_init(self):
        if self.manager is not None:
            payload = self.restore_latest()
            if payload is not None:
                return self.state_from_payload(payload)
        return self.trainer.init_state()

    def restore_latest(self, log_fn=None) -> dict[str, Any] | None:
        """The newest valid checkpoint. Replicated, rank 0 picks its step
        (walking past corrupt files) and broadcasts it, and every rank
        reads that file, so every rank restores the same payload."""
        if self.mesh is None:
            return self.manager.restore_latest(log_fn=log_fn)
        mgr, chosen, payload = self.manager, -1, None
        if self.mesh.rank == 0:
            for step in reversed(mgr.all_steps()):
                payload = mgr.restore(step)
                if payload is not None:
                    chosen = step
                    break
                if log_fn is not None:
                    log_fn(f"checkpoint step {step} unreadable or corrupt; "
                           "walking back to the previous one")
        pick = torch.tensor([chosen + 1 if self.mesh.rank == 0 else 0],
                            dtype=torch.int64, device=self.device)
        step = int(self.mesh.psum(pick, self.mesh.axis_names)) - 1
        if step < 0:
            return None
        if payload is None:
            payload = mgr.restore(step)
        if payload is None:
            raise RuntimeError(
                f"rank {self.mesh.rank} cannot read checkpoint step {step} "
                f"in {mgr.dir}, which rank 0 restores: every rank must see "
                "the same checkpoint directory")
        return payload

    def agreed_seconds(self, dt: float) -> float:
        """The slowest rank's ``dt`` (replicated), so every rank's
        straggler test reads the same number."""
        if self.mesh is None:
            return dt
        t = torch.tensor([-float(dt)], dtype=torch.float64,
                         device=self.device)
        return -float(self.mesh.pmin(t, self.mesh.axis_names))

    def state_from_payload(self, payload: dict[str, Any]):
        # the trainer's native payload IS the canonical format; a legacy
        # padded one converts, the mid-epoch keys ride through so the
        # trainer's guard fires, and the ps_* keys so a parameter-server
        # restore reopens its rounds (the replicated trainer ignores them:
        # redoing the round from the cut gives the same bits)
        native = {"topics_global": canonical_topics(
            payload, self.trainer.n_real_tokens, streamed=True),
            "iteration": payload["iteration"],
            **stream_payload_keys(payload),
            **{k: v for k, v in payload.items()
               if k.startswith((PS_PAYLOAD_PREFIX, "dist_stream_"))}}
        return self.trainer.state_from_payload(native)

    def canonical_payload(self, state) -> dict[str, Any]:
        return self.trainer.host_payload(state)

    def save(self, step: int, payload: dict[str, Any]) -> str:
        """Rank 0 writes; every rank returns once the file is in place
        (the parameter server's one process writes)."""
        if self.mesh is None:
            return self.manager.save(step, payload)
        path = os.path.join(self.manager.dir, f"step_{int(step):08d}.npz")
        if self.mesh.rank == 0:
            path = self.manager.save(step, payload)
        self.mesh.barrier()
        return path

    def run(self, n_iters: int, state, log_fn, checkpoint_every,
            on_chunk=None):
        """The single trainer's boundary-chunked loop over the rank's
        iterations: same history schema, eval cadence and checkpoint
        timing by construction."""
        tr = self.trainer
        carry = {"s": state}

        def run_chunk(chunk):
            carry["s"], stats = tr.run_fused(carry["s"], chunk)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self.config.selfcheck:
                tr.selfcheck(carry["s"])
            return stats

        self._live = carry
        try:
            history = run_boundary_chunked(
                n_iters, int(state.iteration), n_tokens=tr.n_real_tokens,
                eval_every=self.config.eval_every,
                checkpoint_every=checkpoint_every, run_chunk=run_chunk,
                evaluate=lambda: tr.evaluate(carry["s"]),
                save=None if self.manager is None else
                lambda it: self.save(it, tr.host_payload(carry["s"])),
                log_fn=log_fn, on_chunk=on_chunk)
        finally:
            self._live = None
        return carry["s"], history

    def evaluate(self, state) -> float:
        return self.trainer.evaluate(state)

    def dense_W(self, state) -> np.ndarray:
        if self.is_ps:
            _, W = self.trainer.gather_global(state)
        else:
            W = self.trainer.global_W(state)
        return np.array(W.cpu(), np.int32)

    def serving_W(self, state) -> tuple:
        """Exact counts at cursor 0: the distributed trainers publish at
        epoch (round) boundaries."""
        return self.dense_W(state), 0, 1

    def live_serving_W(self):
        if self._live is None:
            return None
        return self.serving_W(self._live["s"])

    def state_nbytes(self, state) -> int:
        return self.trainer.state_nbytes(state)

    def close(self) -> None:
        self.trainer.close()


class LDAEngine:
    """Train EZLDA on one device or on a process mesh, checkpoint it, and
    export it for serving.

    >>> engine = LDAEngine(corpus, LDAConfig(n_topics=64))
    >>> engine.fit(100)
    >>> model = engine.export()          # FrozenLDAModel
    >>> theta = model.transform(new_docs)

    Backends: ``"single"`` (``LDATrainer``: dense, hybrid, warp, streamed
    or disk on one device) and ``"distributed"`` (``DistLDATrainer`` on
    every rank of an initialized ``torch.distributed`` default group, over
    ``mesh`` or ``DistConfig.mesh_shape``, by default ``(world_size, 1)``
    over ``("data", "model")``; with ``DistConfig(w_sync="ps")``
    ``PSDistTrainer``, every worker in this process). ``"auto"`` picks
    distributed when a mesh
    or a ``mesh_shape`` is given, or ``w_sync="ps"`` is asked for, or a
    default group of world size > 1 is initialized: a second visible card
    alone does not count, since a single process has no group. Every
    backend speaks the canonical checkpoint format, so an engine restores
    any engine's checkpoints, whatever its backend or mesh.
    """

    def __init__(self, corpus: Corpus | Sequence[Sequence[int]] | None,
                 config: LDAConfig, device=None, *,
                 n_words: int | None = None, backend: str = "auto",
                 mesh=None, pad_multiple: int = 1024,
                 checkpoint_dir: str | None = None,
                 checkpoint_manager: CheckpointManager | None = None):
        if backend not in ("auto", "single", "distributed"):
            raise ValueError(f"unknown backend {backend!r}: expected "
                             "'auto', 'single', or 'distributed'")
        if checkpoint_dir is not None and checkpoint_manager is not None:
            raise ValueError("pass checkpoint_dir OR checkpoint_manager, "
                             "not both")
        self.word_map = None
        if resolves_to_disk(config):
            # the CorpusStore holds the prepped (relabeled, word-sorted)
            # stream: prepping a corpus here would disagree with it
            if corpus is not None:
                raise ValueError(
                    "corpus_residency='disk' trains from the CorpusStore "
                    f"at corpus_path={config.corpus_path!r}: pass "
                    "corpus=None (the store already holds the prepped "
                    "token stream; write one with "
                    "ShardedCorpus.to_store())")
        elif corpus is None:
            raise ValueError(
                "corpus=None needs corpus_residency='disk' with "
                "corpus_path set: otherwise the engine has no tokens "
                "to train on")
        else:
            if not isinstance(corpus, Corpus):
                docs = [np.asarray(d, np.int64) for d in corpus]
                if n_words is None:
                    n_words = int(max((int(d.max()) for d in docs
                                       if d.size), default=-1)) + 1
                corpus = from_documents(docs, n_words)
            counts = np.asarray(corpus.word_token_counts)
            if counts.size and np.any(np.diff(counts) > 0):
                corpus, self.word_map = relabel_by_frequency(corpus)
        self.corpus = corpus
        self.config = config
        if checkpoint_dir is not None:
            checkpoint_manager = CheckpointManager(checkpoint_dir)
        self.checkpoint_manager = checkpoint_manager
        self._backend_arg = backend
        self._mesh = mesh
        self._pad_multiple = pad_multiple
        self.device = device
        self._backend = self._make_backend()
        self.device = self._backend.device
        self._device_count = torch.cuda.device_count()
        self._state = None
        self._subscribers: list[Callable] = []
        self._serving_seq = 0
        self.restart_report: RestartReport | None = None
        self.history: dict[str, list] = {"iteration": [], "llpt": [],
                                         "tokens_per_sec": [], "stats": []}

    def _make_backend(self, process_mesh=None):
        """The backend of ``self.config`` on the engine's device (the
        reference's ``_make_backend``; re-run by a supervised restart,
        which hands the replicated backend its ``ProcessMesh`` back)."""
        backend, mesh = self._backend_arg, self._mesh
        dc = self.config.dist
        if backend == "auto":
            # an explicit mesh, a mesh_shape or w_sync="ps" asks for the
            # distributed backend; disk residency is single by construction
            wants_dist = (mesh is not None or bool(dc.mesh_shape)
                          or dc.w_sync == "ps")
            if resolves_to_disk(self.config) and not wants_dist:
                backend = "single"
            else:
                backend = "distributed" if (wants_dist
                                            or _world_size() > 1) \
                    else "single"
        if backend == "single" and dc.w_sync == "ps":
            raise ValueError(
                "DistConfig(w_sync='ps') needs the distributed backend: "
                "the parameter server shards W across data-parallel "
                "workers (drop backend='single' or w_sync='ps')")
        if resolves_to_disk(self.config) and backend == "distributed":
            raise ValueError(
                "corpus_residency='disk' needs the single backend: the "
                "paged streaming pipeline owns the device transfer "
                "schedule, which shard_map's static partitioning cannot "
                "express (pass backend='single')")
        if backend == "single":
            if mesh is not None:
                raise ValueError("backend='single' does not take a mesh")
            return _SingleBackend(self.corpus, self.config, self.device,
                                  self.checkpoint_manager)
        return _DistBackend(self.corpus, self.config, self.device,
                            self.checkpoint_manager, mesh,
                            pad_multiple=self._pad_multiple,
                            process_mesh=process_mesh)

    @property
    def backend_name(self) -> str:
        return self._backend.name

    @property
    def trainer(self):
        """The backend's trainer: ``LDATrainer``, ``DistLDATrainer`` or
        ``PSDistTrainer``."""
        return self._backend.trainer

    def _rebuild_trainer(self, report: RestartReport | None = None) -> None:
        """Build the backend anew (the supervisor's recovery path).

        The dead attempt's device memory goes first: its prefetch worker
        stops, the old trainer and its cached pipeline (corpus tensors,
        counts) are dropped, then ``gc.collect()`` and
        ``torch.cuda.empty_cache()``, so a degrade after an out-of-memory
        fault starts from an empty card. Counts are derived state and
        checkpoints are canonical, so a changed visible device count is
        recorded in ``report.elastic_reshards``; the single backend has
        nothing to reshard.
        """
        new_count = torch.cuda.device_count()
        if new_count != self._device_count:
            if report is not None:
                report.elastic_reshards.append((self._device_count,
                                                new_count))
            self._device_count = new_count
        old, self._backend = self._backend, None
        mesh = getattr(old, "mesh", None)
        old.close()
        del old
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._backend = self._make_backend(process_mesh=mesh)

    @property
    def state(self):
        """The current training state: an ``LDAState``, or the
        ``StreamState`` a disk trainer (or a mid-epoch stream) keeps; on
        the distributed backend this rank's ``DistLDAState``,
        ``DistHybridState`` or ``DistStreamState``, or the parameter
        server's ``PSStreamState``."""
        if self._state is None:
            raise RuntimeError("no training state yet: call fit() or "
                               "resume() first")
        return self._state

    @property
    def iteration(self) -> int:
        return int(self.state.iteration)

    def state_nbytes(self) -> int:
        """Live count-state bytes of the training representation: the
        packed buffers for ``format="hybrid"``, D + W for dense; of a
        ``StreamState``, its device-resident counts; on the distributed
        backend, this rank's."""
        return self._backend.state_nbytes(self.state)

    # -- lifecycle -----------------------------------------------------------

    def fit(self, n_iters: int, *,
            log_fn: Callable[[str], None] | None = None,
            checkpoint_every: int | None = None,
            supervise: SupervisePolicy | bool | None = None,
            on_chunk: Callable[[int, int, float], None] | None = None
            ) -> dict[str, list]:
        """Train for n_iters from the current state, the newest checkpoint
        if there is one, or a fresh init; save every ``checkpoint_every``
        iterations. Returns this call's history; ``engine.history``
        accumulates.

        ``supervise=SupervisePolicy(...)`` (or ``True`` for the defaults)
        makes the call a supervised run: restartable faults restore the
        newest valid checkpoint with bounded exponential backoff instead
        of crashing, an out-of-memory fault on the resident path degrades
        once to streamed residency, and the history carries a
        ``"restart_report"`` entry (also ``engine.restart_report``).
        Needs a checkpoint manager.

        ``on_chunk(it, chunk, dt)`` (optional) observes each chunk of
        ``chunk`` iterations that ends at iteration ``it`` and took ``dt``
        seconds, the hooks of a supervised run included; a supervised run
        reports the chunks of every attempt, and its shard-wise attempt
        one chunk an epoch, the epoch's mid-epoch saves included.
        Subscribers (``subscribe``) get a snapshot at every chunk boundary
        and one when the run returns.

        On the distributed backend every rank calls ``fit`` with the same
        arguments."""
        if supervise is not None and supervise is not False:
            policy = SupervisePolicy() if supervise is True else supervise
            return self._fit_supervised(n_iters, policy, log_fn=log_fn,
                                        checkpoint_every=checkpoint_every,
                                        on_chunk=on_chunk)
        if self._state is None:
            self._state = self._backend.restore_or_init()
        hook = on_chunk
        if self._subscribers:
            def hook(it: int, chunk: int, dt: float) -> None:
                self._publish_live(it, chunk, dt)
                if on_chunk is not None:
                    on_chunk(it, chunk, dt)
        self._state, hist = self._backend.run(n_iters, self._state, log_fn,
                                              checkpoint_every,
                                              on_chunk=hook)
        if self._subscribers:
            self.publish_serving()      # the state the run ends at
        for k, v in hist.items():
            self.history[k].extend(v)
        return hist

    def _fit_supervised(self, n_iters: int, policy: SupervisePolicy, *,
                        log_fn: Callable[[str], None] | None = None,
                        checkpoint_every: int | None = None,
                        on_chunk: Callable | None = None
                        ) -> dict[str, list]:
        """fit() under a restart supervisor: the reference's
        ``_fit_supervised``, with its serving notifications, on every
        backend.

        Each attempt restores from the newest VALID checkpoint (corrupt
        ones are walked past), replays deterministically, and so ends
        bitwise where an uninterrupted run ends. With
        ``policy.checkpoint_shards`` (a streamed or disk trainer, the
        streamed replicated trainer, or the parameter server) the
        checkpoints are cut every k shards mid-epoch (the PS: every k
        sub-shards of every worker, in lockstep, through its ``ps_*``
        payload), keyed ``it·(S+1)+cursor`` so they stay monotonic against
        the epoch-boundary saves.

        On the replicated backend each attempt runs with the mesh voting
        before every collective and closes with one more vote, so a fault
        on one rank becomes the same ``RankFault`` on every rank
        (``runtime/fault.py``), and every rank recovers, restores and
        degrades together.
        """
        if self.checkpoint_manager is None:
            raise ValueError("fit(supervise=...) needs checkpoint_dir or "
                             "checkpoint_manager: restart recovery is "
                             "restore-from-checkpoint")
        replicated = self.backend_name == "distributed" \
            and not self._backend.is_ps
        shardwise = policy.checkpoint_shards is not None
        ps_shardwise = shardwise and self._backend.is_ps
        if shardwise and not ps_shardwise \
                and self.trainer.residency not in ("streamed", "disk"):
            raise ValueError(
                "SupervisePolicy.checkpoint_shards needs a streamed or "
                "disk trainer (corpus_residency='streamed' or 'disk', on "
                "the single or the replicated distributed backend) or the "
                "parameter-server backend (DistConfig(w_sync='ps')): "
                "mid-epoch payloads only exist on the streaming pipelines")
        ckpt_every = checkpoint_every or policy.checkpoint_every
        report = RestartReport(completed_steps=0, restarts=0,
                               resumed_from=[])
        timer = StepTimer(window=policy.straggler_window,
                          z_threshold=policy.straggler_z)
        target: dict[str, int | None] = {"v": None}
        merged: dict[str, list] = {"iteration": [], "llpt": [],
                                   "tokens_per_sec": [], "stats": []}
        seen_iters: set[int] = set()

        def merge_hist(hist: dict[str, list]) -> None:
            # restarts replay iterations; dedup so history stays monotone
            for i, it in enumerate(hist["iteration"]):
                if it in seen_iters:
                    continue
                seen_iters.add(it)
                for k in merged:
                    merged[k].append(hist[k][i])

        def ensure_state() -> None:
            if self._state is None:
                payload = self._backend.restore_latest(log_fn=log_fn)
                if payload is not None:
                    self._state = self._backend.state_from_payload(payload)
                    report.resumed_from.append(self.iteration)
                else:
                    self._state = self.trainer.init_state()
            if target["v"] is None:
                target["v"] = self.iteration + n_iters

        def seconds(dt: float) -> float:
            return self._backend.agreed_seconds(dt) if replicated else dt

        def observe(it: int, chunk: int, dt: float) -> None:
            dt = seconds(dt)
            if timer.record(dt / max(chunk, 1)):
                report.straggler_steps.append(it)
            self._publish_live(it, chunk, dt)
            if on_chunk is not None:
                on_chunk(it, chunk, dt)

        def record_epoch(it: int, stats, dt: float, score) -> None:
            n_tok = self.trainer.n_real_tokens
            merge_hist({"iteration": [it], "llpt": [score()],
                        "tokens_per_sec": [n_tok / dt], "stats": [stats]})
            if log_fn:
                log_fn(f"iter={it:4d} llpt={merged['llpt'][-1]:+.4f}"
                       f" tok/s={n_tok / dt:,.0f}")

        def attempt_run() -> None:
            ensure_state()
            remaining = target["v"] - self.iteration
            if remaining <= 0:
                return
            self._state, hist = self._backend.run(
                remaining, self._state, log_fn, ckpt_every,
                on_chunk=observe)
            merge_hist(hist)

        def attempt_shardwise() -> None:
            # a streamed or disk pipeline (single backend) or the streamed
            # replicated trainer: k shards at a time, a mid-epoch save
            # after each group, the epoch closed by run_fused(ss, 1)
            ensure_state()
            if replicated:
                tr = self.trainer
                S, run_shards, payload = tr.stream.n_sub, tr.run_shards, \
                    tr.host_payload
                close = lambda ss: tr.run_fused(ss, 1)  # noqa: E731
                mid_view = None                 # moves still rank-local
                ss = self._state
            else:
                pipe = self.trainer.fused_pipeline()
                S, run_shards, payload = pipe.stream.n_shards, \
                    pipe.run_shards, pipe.stream_payload
                close = lambda ss: pipe.run_fused(ss, 1)[:2]  # noqa: E731
                mid_view = pipe.serving_counts
                # a fresh init arrives as a StreamState, a boundary restore
                # of a streamed trainer too; from_lda_state passes them
                ss = pipe.from_lda_state(self._state)
            k = int(policy.checkpoint_shards)
            first = not merged["iteration"]
            while ss.iteration < target["v"]:
                if chaos.armed():
                    chaos.step_range(ss.iteration, 1)
                ep_t0 = time.perf_counter()
                while ss.cursor < S:
                    t0 = time.perf_counter()
                    ss = run_shards(ss, k)
                    self._state = ss
                    dt = seconds(time.perf_counter() - t0)
                    step_key = ss.iteration * (S + 1) + ss.cursor
                    if timer.record(dt / max(min(k, S), 1)):
                        report.straggler_steps.append(step_key)
                    if ss.cursor < S:       # the boundary save covers S
                        self._backend.save(step_key, payload(ss))
                        if self._subscribers and mid_view is not None:
                            self._notify(*mid_view(ss), ss.iteration)
                ss, stats = close(ss)
                self._state = ss
                if self._subscribers:       # the exact epoch-boundary view
                    self._notify(*self._backend.serving_W(ss),
                                 ss.iteration)
                dt = seconds(time.perf_counter() - ep_t0)
                it = ss.iteration
                if on_chunk is not None:
                    on_chunk(it, 1, dt)
                self._backend.save(it * (S + 1), payload(ss))
                if it % self.config.eval_every == 0 or first:
                    first = False
                    last = {kk: float(np.asarray(torch.as_tensor(v).cpu())
                                      [-1])
                            for kk, v in stats._asdict().items()}
                    record_epoch(it, last, dt,
                                 lambda: self.trainer.evaluate(ss))

        def attempt_shardwise_ps() -> None:
            # the parameter server's mid-round surface: lockstep sub-shard
            # groups (aligned clocks), ps_* payloads at every cut, step
            # keys on the same it·(R+1)+cursor grid as the streamed path
            ensure_state()
            tr = self.trainer
            mgr = self.checkpoint_manager
            R = tr._R
            k = int(policy.checkpoint_shards)
            ss = self._state
            first = not merged["iteration"]
            denom = float(max(int(tr.sc.mask.sum()), 1))
            while ss.iteration < target["v"]:
                it0 = ss.iteration
                if chaos.armed():
                    chaos.step_range(it0, 1)
                ep_t0 = time.perf_counter()
                while ss.iteration == it0:
                    t0 = time.perf_counter()
                    ss = tr.run_shards(ss, k)
                    self._state = ss
                    dt = time.perf_counter() - t0
                    cur = int(ss.cursors.max())
                    step_key = ss.iteration * (R + 1) + cur
                    if timer.record(dt / max(min(k, R), 1)):
                        report.straggler_steps.append(step_key)
                    if ss.iteration == it0 and cur > 0:
                        mgr.save(step_key, tr.host_payload(ss))
                dt = time.perf_counter() - ep_t0
                it = ss.iteration
                if on_chunk is not None:
                    on_chunk(it, 1, dt)
                mgr.save(it * (R + 1), tr.host_payload(ss))
                if self._subscribers:   # aligned clocks: exact counts
                    self._notify(*self._backend.serving_W(ss), it)
                _n_surv, sums = ss.stat_rounds.pop(it0, (0, np.zeros(4)))
                if it % self.config.eval_every == 0 or first:
                    first = False
                    m = np.asarray(sums, np.float64) / denom
                    record_epoch(it, {"frac_skipped": float(m[0]),
                                      "frac_m_final": float(m[1]),
                                      "frac_unchanged": float(m[2]),
                                      "frac_at_max": float(m[3]),
                                      "frac_q_branch": 0.0}, dt,
                                 lambda: tr.evaluate(ss))

        def agreed(attempt: Callable[[], None]) -> Callable[[], None]:
            # the replicated attempt: every collective votes first, and the
            # attempt closes with one more vote, which a faulted rank fills
            def run() -> None:
                mesh = self._backend.mesh
                mesh.voting = True
                try:
                    row = None
                    try:
                        attempt()
                    except (RankFault, RankAbort):
                        raise                   # agreed inside a vote
                    except BaseException as exc:
                        row = fault_vote(exc, policy.restartable)
                        if row[0] == FAULT_FATAL:
                            # the others stop with RankAbort; this rank
                            # raises its own fault
                            with contextlib.suppress(RankAbort):
                                mesh.agree(row)
                            raise
                        if log_fn is not None:
                            log_fn(f"rank {mesh.rank}: "
                                   f"{type(exc).__name__}: {exc}")
                        # its frames hold the attempt's device tensors
                        traceback.clear_frames(exc.__traceback__)
                        exc.__traceback__ = None
                    mesh.agree(row)
                finally:
                    mesh.voting = False
            return run

        def recover(exc: BaseException) -> None:
            # the failed attempt's frames hold its device tensors (their
            # locals, and the closures of the functions they ran): clear
            # them and drop the traceback before the rebuild frees the card
            traceback.clear_frames(exc.__traceback__)
            exc.__traceback__ = None
            self._state = None      # the next attempt restores
            if is_oom_error(exc) and not report.degraded_to_streamed \
                    and self.config.corpus_residency \
                    not in ("streamed", "disk"):
                warnings.warn(
                    "supervised fit hit an out-of-memory fault on the "
                    f"resident path ({exc}); degrading once to "
                    "corpus_residency='streamed' and restoring from the "
                    "newest checkpoint", RuntimeWarning, stacklevel=2)
                self.config = dataclasses.replace(
                    self.config, corpus_residency="streamed")
                report.degraded_to_streamed = True
            self._rebuild_trainer(report)

        attempt = attempt_run
        if shardwise:
            attempt = attempt_shardwise_ps if ps_shardwise \
                else attempt_shardwise
        if replicated:
            attempt = agreed(attempt)
        supervised_loop(attempt, recover, policy, report)
        if not shardwise and self.iteration % ckpt_every != 0:
            self.save()
        report.completed_steps = self.iteration
        report.timer_summary = timer.summary
        self.restart_report = report
        for k, v in merged.items():
            self.history[k].extend(v)
        out: dict[str, Any] = dict(merged)
        out["restart_report"] = report
        return out

    def resume(self) -> "LDAEngine":
        """Restore the newest checkpoint into the engine, or a fresh init
        when there is none yet. Returns self (chainable)."""
        if self.checkpoint_manager is None:
            raise ValueError("resume() needs checkpoint_dir or "
                             "checkpoint_manager")
        self._state = self._backend.restore_or_init()
        return self

    def score(self) -> float:
        """Training-corpus LLPT (Eq 5) at the current state."""
        return self._backend.evaluate(self.state)

    # -- checkpoints ---------------------------------------------------------

    def host_payload(self) -> dict[str, Any]:
        """The canonical checkpoint payload for the current state (with
        the mid-epoch keys when a stream is mid-epoch)."""
        return self._backend.canonical_payload(self.state)

    def save(self) -> str:
        if self.checkpoint_manager is None:
            raise ValueError("save() needs checkpoint_dir or "
                             "checkpoint_manager")
        return self._backend.save(self.iteration, self.host_payload())

    def restore(self, payload: dict[str, Any]) -> "LDAEngine":
        """Adopt a canonical (or legacy padded) payload of either package
        as the current state; see ``lda/convert.py``."""
        self._state = self._backend.state_from_payload(payload)
        return self

    # -- serving -------------------------------------------------------------

    def subscribe(self, fn: Callable) -> Callable[[], None]:
        """Register ``fn(ServingSnapshot)``; returns an unsubscribe
        callable.

        Subscribers receive one snapshot per publish point: every chunk
        boundary during ``fit()`` (plus a final one when the run returns),
        every shard group of a shard-wise supervised fit (a mid-epoch
        bounded-staleness view, cursor > 0, on the single backend), and
        every explicit ``publish_serving()``. ``repro_torch.serve.attach``
        wires a snapshot stream into a running ``LDAService``."""
        self._subscribers.append(fn)

        def unsubscribe() -> None:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass
        return unsubscribe

    def publish_serving(self):
        """Snapshot the CURRENT state (exact counts at a boundary, the
        epoch-start W plus the sampled shards' moves mid-epoch), deliver
        it to every subscriber, and return it (a ``ServingSnapshot``)."""
        W, cursor, n_shards = self._backend.serving_W(self.state)
        return self._notify(W, cursor, n_shards, self.iteration)

    def _notify(self, W, cursor, n_shards, iteration):
        from repro_torch.serve.refresh import ServingSnapshot
        self._serving_seq += 1
        snap = ServingSnapshot(
            W=np.ascontiguousarray(W, np.int32), alpha=self.config.alpha_,
            beta=self.config.beta, g=self.config.g,
            iteration=int(iteration), cursor=int(cursor),
            n_shards=int(n_shards), seq=self._serving_seq,
            word_map=self.word_map, tile_size=self.config.tile_size)
        for fn in list(self._subscribers):
            fn(snap)
        return snap

    def _publish_live(self, iteration: int, chunk: int = 1,
                      dt: float = 0.0) -> None:
        """``on_chunk``-shaped publish hook: snapshot the backend's state
        inside its run (quiescent at chunk boundaries) if anyone
        listens."""
        if not self._subscribers:
            return
        view = self._backend.live_serving_W()
        if view is None:
            return
        self._notify(view[0], view[1], view[2], iteration)

    def _dense_W(self) -> np.ndarray:
        return self._backend.dense_W(self.state)

    def export(self) -> FrozenLDAModel:
        """Freeze the current state into the serving artifact, on the
        engine's device."""
        return FrozenLDAModel(
            W=self._dense_W(), alpha=self.config.alpha_,
            beta=self.config.beta, g=self.config.g, word_map=self.word_map,
            tile_size=self.config.tile_size, device=self.device)

    def top_words(self, k: int = 10) -> np.ndarray:
        """(K, k) top word ids per topic at the current state (original
        vocab), straight from the counts."""
        return _top_words(self._dense_W(), self.word_map, k)
