"""Single-device LDA trainer: sample -> update -> eval loop.

Port of the dense part of ``src/repro/lda/trainer.py``. Two execution
modes share one state:

  * ``step()``: the stepwise oracle — the exact sampler over every token
    (``kernels.ops.sample_tokens`` for ``impl="kernel"``,
    ``core.three_branch.sample`` for ``impl="torch"``), or with
    ``sampler="warp"`` one MH iteration with alias tables rebuilt from the
    live Ŵ (``kernels.ops.sample_warp_tokens`` / ``core.mh.sample_warp``),
    then a full count rebuild;
  * ``run_fused()`` (and ``run()`` with ``config.fused``): the fused
    pipeline of ``train/lda_step.py`` — phase-1 skip, survivor chunks,
    ±1 delta updates.

Both draw iteration ``i``'s uniforms from the same generator, so they
produce identical topics and counts. With ``format="hybrid"`` the live
state exists only inside the fused pipeline (``HybridFusedPipeline``), so
``run()`` takes the fused loop whatever ``config.fused`` says, as the
reference does; ``step()`` stays the dense oracle.

The failure model's hooks (as in the reference): ``run_boundary_chunked``
fires an armed chaos plan's step faults (``runtime/chaos.py``) at the
start of each chunk and reports every chunk's wall time to ``on_chunk``
(the fit supervisor's straggler detector); the stepwise loop does both
per step. Under ``config.selfcheck`` the fused loop runs the pipeline's
count tripwires after each chunk, the stepwise loop ``check_dense_counts``
after each step, and ``evaluate`` refuses a non-finite LLPT
(``lda/invariants.py``). Off, each hook costs one flag test and no host
sync.

Every full count rebuild (the initial counts, ``state_from_topics`` and
``step``) goes through ``kernels.ops.update_counts`` (the ``histogram``
kernel) with ``impl="kernel"`` and through ``core.esca.update_counts``
with ``impl="torch"``; the two are bitwise equal.

Residency (``train/lda_step.py::resolve_residency``): with
``corpus_residency="streamed"`` (or "auto" past the device budget) the
token arrays stay on the host as a ``ShardedCorpus`` and the fused loop
is the ``StreamingPipeline``'s, one epoch shard at a time; with "disk"
the corpus is the ``CorpusStore`` at ``config.corpus_path`` and W pages
by shard too. Their initial topics are the resident draw, their counts
are folded shard by shard through the ``histogram`` kernel, their LLPT
is folded over the shards, and their checkpoints go through the stream
payload (``StreamingPipeline.stream_payload``), which may be mid-epoch.
A streamed trainer hands back a dense ``LDAState`` after ``run``; a disk
trainer keeps its ``StreamState``. The stepwise oracle (``step``) needs
the token arrays resident.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import esca, llpt as llpt_mod, mh, three_branch
from repro_torch.core.inverted_index import doc_segment_ids
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sample_warp import alias_tables
from repro_torch.lda import invariants
from repro_torch.lda.convert import (canonical_topics, key_data,
                                     stream_payload_keys)
from repro_torch.lda.corpus import Corpus, pad_corpus, shard_stream
from repro_torch.lda.model import LDAConfig, LDAState, uniforms_generator
from repro_torch.lda.storage import CorpusStore
from repro_torch.runtime import chaos
from repro_torch.runtime.device import resolve_device
from repro_torch.train.lda_step import (FusedPipeline, HybridFusedPipeline,
                                        StreamingHybridPipeline,
                                        StreamingPipeline, StreamState,
                                        draw_uniforms, draw_warp_uniforms,
                                        resolve_residency, resolves_to_disk)

__all__ = ["LDATrainer", "chunk_to_boundary", "run_boundary_chunked"]


def chunk_to_boundary(it_now: int, done: int, remaining: int,
                      eval_every: int,
                      checkpoint_every: int | None = None) -> int:
    """Iterations to run before the next absolute eval/ckpt boundary.

    The first chunk is a single iteration, so a baseline eval is recorded
    after it; later chunks end on every multiple of ``eval_every`` (and of
    ``checkpoint_every``) that a stepwise loop would hit.
    """
    if done == 0:
        return min(1, remaining)
    chunk = eval_every - it_now % eval_every
    if checkpoint_every:
        chunk = min(chunk, checkpoint_every - it_now % checkpoint_every)
    return min(chunk, remaining)


def run_boundary_chunked(n_iters: int, start_iter: int, *, n_tokens: int,
                         eval_every: int, checkpoint_every: int | None,
                         run_chunk: Callable, evaluate: Callable,
                         save: Callable | None,
                         log_fn: Callable[[str], None] | None,
                         on_chunk: Callable | None = None) -> dict:
    """The boundary-chunked driver ``fit()`` runs through.

    ``run_chunk(chunk) -> stacked stats`` advances the carried state by
    ``chunk`` iterations and returns once the device is done with them;
    ``evaluate() -> float`` scores the current state; ``save(it)``
    checkpoints it after every chunk that ends on a multiple of
    ``checkpoint_every``. ``on_chunk(it, chunk, dt)`` (optional) observes
    every chunk's wall time without changing the chunking. An armed chaos
    plan's step faults fire here, at the start of the chunk that covers
    their step, inside the timed window.
    """
    history: dict[str, list] = {"iteration": [], "llpt": [],
                                "tokens_per_sec": [], "stats": []}
    done = 0
    while done < n_iters:
        chunk = chunk_to_boundary(start_iter + done, done, n_iters - done,
                                  eval_every, checkpoint_every)
        t0 = time.perf_counter()
        if chaos.armed():
            chaos.step_range(start_iter + done, chunk)
        stats = run_chunk(chunk)
        dt = time.perf_counter() - t0
        done += chunk
        it = start_iter + done
        if on_chunk is not None:
            on_chunk(it, chunk, dt)
        if it % eval_every == 0 or done == chunk:
            score = evaluate()
            last = {k: float(np.asarray(torch.as_tensor(v).cpu())[-1])
                    for k, v in stats._asdict().items()}
            history["iteration"].append(it)
            history["llpt"].append(score)
            history["tokens_per_sec"].append(n_tokens * chunk / dt)
            history["stats"].append(last)
            if log_fn:
                log_fn(f"iter={it:4d} llpt={score:+.4f} "
                       f"tok/s={n_tokens*chunk/dt:,.0f} "
                       f"unchanged={last.get('frac_unchanged', 0):.3f}")
        if checkpoint_every and save is not None \
                and it % checkpoint_every == 0:
            save(it)
    return history


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LDATrainer:
    """Owns one corpus's token arrays: on the training device when
    resident, on the host (``ShardedCorpus``) when streamed, on disk
    (``CorpusStore``, ``corpus=None``) with ``corpus_residency="disk"``.

    ``device=None`` means the CUDA card (an error without one); pass
    ``device="cpu"`` for the plain-PyTorch path on the CPU. With a
    ``checkpoint_manager``, ``run`` saves ``host_payload`` (padded
    ``topics``, ``key``, ``iteration``) every ``checkpoint_every``
    iterations and ``restore_or_init`` restores the newest checkpoint.
    """

    def __init__(self, corpus: Corpus | None, config: LDAConfig, *,
                 device=None, checkpoint_manager: Any | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.checkpoint_manager = checkpoint_manager
        self.corpus = corpus
        self.store = None
        self.word_ids = self.doc_ids = self.mask = None
        self._fused_pipeline: FusedPipeline | None = None
        self._doc_index: mh.DocIndex | None = None
        self._live: dict | None = None      # a run's carry, for serving
        self.plan = three_branch.build_plan(config)
        if resolves_to_disk(config):
            # the CorpusStore's shard files are the corpus: the trainer
            # holds the store and its shapes, never the token list
            self.store = CorpusStore.open(config.corpus_path)
            if self.store.shard_len % config.tile_size != 0:
                raise ValueError(
                    f"CorpusStore shard_len {self.store.shard_len} is not "
                    f"a multiple of tile_size {config.tile_size}: rewrite "
                    "the store from a stream sharded with "
                    "multiple=tile_size, or change tile_size")
            self.n_docs = self.store.n_docs
            self.n_words = self.store.n_words
            self.n_real_tokens = self.store.n_tokens
            self.n_padded_tokens = self.store.n_padded
            self.residency, self.n_stream_shards = "disk", \
                self.store.n_shards
            return
        if corpus is None:
            raise ValueError(
                "corpus=None needs corpus_residency='disk' with "
                "corpus_path set: otherwise the trainer has no tokens")
        corpus.validate()
        padded, mask = pad_corpus(corpus, config.tile_size)
        self.n_docs = corpus.n_docs
        self.n_words = corpus.n_words
        self.n_real_tokens = corpus.n_tokens
        self.n_padded_tokens = int(padded.word_ids.shape[0])
        self.residency, self.n_stream_shards = resolve_residency(
            config, self.n_padded_tokens, self.device)
        if self.residency == "streamed":
            # the token arrays stay on the host, in the pipeline's shards
            return
        to_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.int32)).to(self.device)
        self.word_ids = to_dev(padded.word_ids)
        self.doc_ids = to_dev(padded.doc_ids)
        self.mask = to_dev(mask)
        if config.impl == "kernel":
            # the document view of the real tokens, for the D rebuild
            self.inv_token_idx = to_dev(corpus.inv_token_idx)
            self.doc_segments = to_dev(doc_segment_ids(corpus))
            self.count_plans = kops.count_plans(
                self.word_ids, self.doc_segments, n_docs=self.n_docs,
                n_words=self.n_words, n_topics=config.n_topics)

    @property
    def streams(self) -> bool:
        """True when the corpus is streamed by shard ("streamed", "disk")."""
        return self.residency != "full"

    def _need_resident(self, what: str) -> None:
        if self.streams:
            raise ValueError(
                f"{what} needs the token arrays resident; corpus_residency="
                f"{self.residency!r} trains only through run()/run_fused "
                "(the streaming pipeline)")

    # -- state ------------------------------------------------------------

    def rebuild_counts(self, topics: torch.Tensor):
        """(D, W) of padded-order ``topics``: the ``histogram`` kernel with
        ``impl="kernel"``, ``esca.update_counts`` with ``"torch"``."""
        self._need_resident("rebuild_counts")
        kw = dict(n_docs=self.n_docs, n_words=self.n_words,
                  n_topics=self.config.n_topics)
        if self.config.impl == "kernel":
            return kops.update_counts(
                self.word_ids, self.doc_ids, topics, self.mask,
                self.inv_token_idx, self.doc_segments, plans=self.count_plans,
                **kw)
        return esca.update_counts(self.word_ids, self.doc_ids, topics,
                                  self.mask, **kw)

    def init_state(self):
        """Random topics (stream 0 of ``config.seed``) and their counts. A
        streamed or disk trainer draws the same topics over the padded
        slots on the same device and folds their counts shard by shard
        (a ``StreamState``)."""
        topics = esca.init_topics(
            uniforms_generator(self.config.seed, 0, self.device),
            (self.n_padded_tokens,), self.config.n_topics)
        if self.streams:
            return self.fused_pipeline().state_from_topics(
                topics.cpu().numpy(), 0)
        return self.state_from_topics(topics, 0)

    def restore_or_init(self):
        """The newest checkpoint's state, or a fresh init without one."""
        if self.checkpoint_manager is not None:
            payload = self.checkpoint_manager.restore_latest()
            if payload is not None:
                return self.state_from_payload(payload)
        return self.init_state()

    def host_payload(self, state) -> dict[str, Any]:
        """The trainer's checkpoint payload: ``topics`` (padded for a
        dense state; unpadded from a ``StreamState``, with the mid-epoch
        keys when it is mid-epoch), the key data of
        ``PRNGKey(config.seed)`` (``convert.key_data``) and the
        iteration."""
        if isinstance(state, StreamState):
            payload = self.fused_pipeline().stream_payload(state)
            payload["topics"] = payload.pop("topics_global")
            return payload
        return {**state.host_payload(), "key": key_data(self.config.seed)}

    def state_from_payload(self, payload: dict[str, Any]):
        """Adopt a trainer payload (padded or unpadded ``topics``) or a
        canonical one (``topics_global``): ``convert.canonical_topics``,
        then D and W rebuilt from the topics. A resident trainer rejects a
        mid-epoch streamed payload; a streamed or disk one restores any,
        through ``StreamingPipeline.state_from_stream_payload``. The key
        is not read (see ``lda/convert.py``)."""
        topics = canonical_topics(payload, self.n_real_tokens,
                                  padded_len=self.n_padded_tokens,
                                  streamed=self.streams)
        if self.streams:
            return self.fused_pipeline().state_from_stream_payload({
                "topics_global": topics,
                "iteration": int(payload["iteration"]),
                **stream_payload_keys(payload)})
        k = self.config.n_topics
        if topics.size and (topics.min() < 0 or topics.max() >= k):
            raise ValueError(f"checkpoint topics lie outside [0, {k})")
        padded = np.zeros(self.n_padded_tokens, np.int32)   # pad: mask 0
        padded[:self.n_real_tokens] = topics
        return self.state_from_topics(padded, int(payload["iteration"]))

    def state_from_topics(self, topics, iteration: int) -> LDAState:
        """Rebuild D and W from padded-order topics (counts are derived)."""
        self._need_resident("state_from_topics")
        if isinstance(topics, torch.Tensor):
            topics = topics.to(self.device, torch.int32)
        else:
            topics = torch.from_numpy(np.array(topics, np.int32)).to(
                self.device)
        if topics.shape != self.word_ids.shape:
            raise ValueError(
                f"topics have shape {tuple(topics.shape)} but this "
                f"trainer's padded corpus has {tuple(self.word_ids.shape)} "
                "token slots")
        D, W = self.rebuild_counts(topics)
        return LDAState(topics=topics, D=D, W=W, iteration=int(iteration))

    # -- steps ------------------------------------------------------------

    @property
    def doc_index(self) -> mh.DocIndex:
        """The warp engine's doc -> token index (built once)."""
        if self._doc_index is None:
            self._doc_index = mh.build_doc_index(self.doc_ids, self.mask,
                                                 self.n_docs)
        return self._doc_index

    def _warp_step(self, state: LDAState):
        """One warp MH iteration over every token, the alias tables rebuilt
        from the live Ŵ (no staleness)."""
        cfg = self.config
        u = draw_warp_uniforms(cfg.seed, int(state.iteration),
                               self.n_padded_tokens, cfg.mh_cycles,
                               self.device)
        W_hat = esca.compute_w_hat(state.W, cfg.beta)
        kernel = cfg.impl == "kernel"
        tables = (alias_tables if kernel else mh.build_alias_tables)(W_hat)
        sample = kops.sample_warp_tokens if kernel else mh.sample_warp
        return sample(*u, self.word_ids, self.doc_ids, state.topics, state.D,
                      W_hat, tables, self.doc_index, alpha=cfg.alpha_,
                      mask=self.mask)

    def step(self, state: LDAState) -> tuple[LDAState, dict]:
        """The stepwise oracle: the sampler on every token + rebuild."""
        self._need_resident("the stepwise oracle (step)")
        cfg = self.config
        if cfg.sampler == "warp":
            new_topics, stats = self._warp_step(state)
        else:
            u = draw_uniforms(cfg.seed, int(state.iteration),
                              self.n_padded_tokens, self.device)
            if cfg.impl == "kernel":
                W_hat = esca.compute_w_hat(state.W, cfg.beta)
                new_topics, stats = kops.sample_tokens(
                    u, self.word_ids, self.doc_ids, state.topics, state.D,
                    W_hat, alpha=cfg.alpha_)
            else:
                new_topics, stats = three_branch.sample(
                    u, self.plan, self.word_ids, self.doc_ids, state.topics,
                    state.D, state.W, cfg)
        D, W = self.rebuild_counts(new_topics)
        return (LDAState(topics=new_topics, D=D, W=W,
                         iteration=int(state.iteration) + 1),
                dict(stats._asdict()))

    def close(self) -> None:
        """Stop the streaming pipeline's prefetch worker and drop the
        cached pipeline (a supervised restart builds a new trainer)."""
        pipe, self._fused_pipeline = self._fused_pipeline, None
        if isinstance(pipe, StreamingPipeline):
            pipe.close()

    def fused_pipeline(self) -> FusedPipeline:
        """The fused pipeline of ``config.format`` and the residency (built
        once)."""
        if self._fused_pipeline is None:
            cfg = self.config
            kw = dict(n_docs=self.n_docs, n_words=self.n_words, config=cfg)
            hybrid = cfg.format == "hybrid"
            if self.streams:
                stream = self.store if self.store is not None else \
                    shard_stream(self.corpus, self.n_stream_shards,
                                 multiple=cfg.tile_size)
                kw["device"] = self.device
                if hybrid:
                    self._fused_pipeline = StreamingHybridPipeline(
                        stream, corpus=self.corpus if self.store is None
                        else self.store.corpus_meta(), **kw)
                else:
                    self._fused_pipeline = StreamingPipeline(stream, **kw)
            elif hybrid:
                self._fused_pipeline = HybridFusedPipeline(
                    self.word_ids, self.doc_ids, self.mask,
                    corpus=self.corpus, **kw)
            else:
                self._fused_pipeline = FusedPipeline(
                    self.word_ids, self.doc_ids, self.mask, **kw)
        return self._fused_pipeline

    def live_serving_W(self):
        """``(W, cursor, n_shards)`` of the state inside a run, or None
        outside one: read at chunk boundaries (the ``on_chunk`` hook),
        where the run's carry is quiescent. A mid-epoch ``StreamState``
        gives the epoch-start W plus the sampled shards' moves
        (``serving_counts``); every other state its exact W at cursor 0."""
        if self._live is None:
            return None
        fs = self._live["fs"]
        if isinstance(fs, StreamState):
            return self.fused_pipeline().serving_counts(fs)
        if not hasattr(fs, "W"):                 # hybrid packed: densify
            fs = self.fused_pipeline().to_lda_state(fs)
        return fs.W.cpu().numpy().astype(np.int32), 0, 1

    def evaluate(self, state) -> float:
        """LLPT of a dense state (a hybrid run hands its densified one) or
        of a boundary ``StreamState``; a streamed trainer folds it over
        the shards, bitwise the resident value."""
        if isinstance(state, StreamState):
            score = self.fused_pipeline().eval_llpt(state)
        elif self.streams:
            score = self.fused_pipeline().llpt_of(
                state.D, state.W, state.W.sum(dim=0, dtype=torch.int32))
        else:
            score = float(llpt_mod.llpt(
                self.word_ids, self.doc_ids, self.mask, state.D, state.W,
                alpha=self.config.alpha_, beta=self.config.beta,
                tile_size=self.config.tile_size))
        if self.config.selfcheck and not np.isfinite(score):
            raise invariants.InvariantViolation(
                "finite_llpt", f"evaluate (iteration "
                f"{int(state.iteration)})", f"llpt={score!r}")
        return score

    # -- loops ------------------------------------------------------------

    def _save(self, state) -> None:
        self.checkpoint_manager.save(int(state.iteration),
                                     self.host_payload(state))

    def run_fused(self, n_iters: int, state=None,
                  log_fn: Callable[[str], None] | None = None,
                  checkpoint_every: int | None = None, *,
                  on_chunk: Callable | None = None) -> tuple[Any, dict]:
        """Fused loop, chunked at the absolute eval (and checkpoint)
        boundaries; saves after each chunk that ends on a multiple of
        ``checkpoint_every``. A disk trainer returns its ``StreamState``,
        every other a dense ``LDAState``."""
        state = self.restore_or_init() if state is None else state
        pipe = self.fused_pipeline()
        carry = {"fs": pipe.from_lda_state(state)}
        selfcheck = self.config.selfcheck

        def run_chunk(chunk):
            carry["fs"], stats, _ = pipe.run_fused(carry["fs"], chunk)
            _synchronize(self.device)
            if selfcheck:
                pipe.selfcheck(carry["fs"])
            return stats

        # a streamed state is scored and saved as it is: the LLPT folds
        # over the shards, the payload is the stream's
        live = (lambda: carry["fs"]) if self.streams else \
            (lambda: pipe.to_lda_state(carry["fs"]))
        self._live = carry
        try:
            history = run_boundary_chunked(
                n_iters, int(state.iteration), n_tokens=self.n_real_tokens,
                eval_every=self.config.eval_every,
                checkpoint_every=checkpoint_every, run_chunk=run_chunk,
                evaluate=lambda: self.evaluate(live()),
                save=None if self.checkpoint_manager is None else
                lambda it: self._save(live()),
                log_fn=log_fn, on_chunk=on_chunk)
        finally:
            self._live = None
        if self.residency == "disk":
            return carry["fs"], history
        return pipe.to_lda_state(carry["fs"]), history

    def run(self, n_iters: int, state: LDAState | None = None,
            log_fn: Callable[[str], None] | None = None,
            checkpoint_every: int | None = None, *,
            on_chunk: Callable | None = None) -> tuple[LDAState, dict]:
        if self.config.fused or self.config.format == "hybrid" \
                or self.streams:
            return self.run_fused(n_iters, state, log_fn, checkpoint_every,
                                  on_chunk=on_chunk)
        state = self.restore_or_init() if state is None else state
        live = {"fs": state}
        self._live = live
        try:
            return self._run_stepwise(state, n_iters, live, log_fn,
                                      checkpoint_every, on_chunk)
        finally:
            self._live = None

    def _run_stepwise(self, state, n_iters: int, live: dict, log_fn,
                      checkpoint_every, on_chunk):
        history: dict[str, list] = {"iteration": [], "llpt": [],
                                    "tokens_per_sec": [], "stats": []}
        start_iter = int(state.iteration)
        for i in range(start_iter, start_iter + n_iters):
            t0 = time.perf_counter()
            if chaos.armed():
                chaos.step_range(i, 1)
            state, stats = self.step(state)
            live["fs"] = state
            _synchronize(self.device)
            dt = time.perf_counter() - t0
            if self.config.selfcheck:
                invariants.check_dense_counts(
                    state.D, state.W, n_tokens=self.n_real_tokens,
                    where=f"step (iteration {i + 1})")
            if on_chunk is not None:
                on_chunk(i + 1, 1, dt)
            if (i + 1) % self.config.eval_every == 0 or i == start_iter:
                score = self.evaluate(state)
                history["iteration"].append(i + 1)
                history["llpt"].append(score)
                history["tokens_per_sec"].append(self.n_real_tokens / dt)
                history["stats"].append(
                    {k: float(torch.as_tensor(v)) for k, v in stats.items()})
                if log_fn:
                    log_fn(f"iter={i+1:4d} llpt={score:+.4f} "
                           f"tok/s={self.n_real_tokens/dt:,.0f} "
                           f"unchanged="
                           f"{history['stats'][-1]['frac_unchanged']:.3f}")
            if checkpoint_every and self.checkpoint_manager is not None \
                    and (i + 1) % checkpoint_every == 0:
                self._save(state)
        return state, history
