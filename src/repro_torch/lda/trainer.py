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

Every full count rebuild (the initial counts, ``state_from_topics`` and
``step``) goes through ``kernels.ops.update_counts`` (the ``histogram``
kernel) with ``impl="kernel"`` and through ``core.esca.update_counts``
with ``impl="torch"``; the two are bitwise equal.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import esca, llpt as llpt_mod, mh, three_branch
from repro_torch.core.inverted_index import doc_segment_ids
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sample_warp import alias_tables
from repro_torch.lda.corpus import Corpus, pad_corpus
from repro_torch.lda.model import LDAConfig, LDAState, uniforms_generator
from repro_torch.runtime.device import resolve_device
from repro_torch.train.lda_step import (FusedPipeline, HybridFusedPipeline,
                                        draw_uniforms, draw_warp_uniforms)

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
                         eval_every: int, run_chunk: Callable,
                         evaluate: Callable,
                         log_fn: Callable[[str], None] | None) -> dict:
    """The boundary-chunked driver ``fit()`` runs through.

    ``run_chunk(chunk) -> stacked stats`` advances the carried state by
    ``chunk`` iterations and returns once the device is done with them;
    ``evaluate() -> float`` scores the current state.
    """
    history: dict[str, list] = {"iteration": [], "llpt": [],
                                "tokens_per_sec": [], "stats": []}
    done = 0
    while done < n_iters:
        chunk = chunk_to_boundary(start_iter + done, done, n_iters - done,
                                  eval_every)
        t0 = time.perf_counter()
        stats = run_chunk(chunk)
        dt = time.perf_counter() - t0
        done += chunk
        it = start_iter + done
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
    return history


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LDATrainer:
    """Owns one corpus's token arrays on the training device.

    ``device=None`` means the CUDA card (an error without one); pass
    ``device="cpu"`` for the plain-PyTorch path on the CPU.
    """

    def __init__(self, corpus: Corpus, config: LDAConfig, *, device=None):
        self.device = resolve_device(device)
        corpus.validate()
        self.config = config
        self.corpus = corpus
        padded, mask = pad_corpus(corpus, config.tile_size)
        to_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.int32)).to(self.device)
        self.word_ids = to_dev(padded.word_ids)
        self.doc_ids = to_dev(padded.doc_ids)
        self.mask = to_dev(mask)
        self.n_docs = corpus.n_docs
        self.n_words = corpus.n_words
        self.n_real_tokens = corpus.n_tokens
        self.n_padded_tokens = int(padded.word_ids.shape[0])
        if config.impl == "kernel":
            # the document view of the real tokens, for the D rebuild
            self.inv_token_idx = to_dev(corpus.inv_token_idx)
            self.doc_segments = to_dev(doc_segment_ids(corpus))
            self.count_plans = kops.count_plans(
                self.word_ids, self.doc_segments, n_docs=self.n_docs,
                n_words=self.n_words, n_topics=config.n_topics)
        self.plan = three_branch.build_plan(config)
        self._fused_pipeline: FusedPipeline | None = None
        self._doc_index: mh.DocIndex | None = None

    # -- state ------------------------------------------------------------

    def rebuild_counts(self, topics: torch.Tensor):
        """(D, W) of padded-order ``topics``: the ``histogram`` kernel with
        ``impl="kernel"``, ``esca.update_counts`` with ``"torch"``."""
        kw = dict(n_docs=self.n_docs, n_words=self.n_words,
                  n_topics=self.config.n_topics)
        if self.config.impl == "kernel":
            return kops.update_counts(
                self.word_ids, self.doc_ids, topics, self.mask,
                self.inv_token_idx, self.doc_segments, plans=self.count_plans,
                **kw)
        return esca.update_counts(self.word_ids, self.doc_ids, topics,
                                  self.mask, **kw)

    def init_state(self) -> LDAState:
        """Random topics (stream 0 of ``config.seed``) and their counts."""
        topics = esca.init_topics(
            uniforms_generator(self.config.seed, 0, self.device),
            self.word_ids.shape, self.config.n_topics)
        return self.state_from_topics(topics, 0)

    def state_from_topics(self, topics, iteration: int) -> LDAState:
        """Rebuild D and W from padded-order topics (counts are derived)."""
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

    def fused_pipeline(self) -> FusedPipeline:
        """The fused pipeline of ``config.format`` (built once)."""
        if self._fused_pipeline is None:
            kw = dict(n_docs=self.n_docs, n_words=self.n_words,
                      config=self.config)
            if self.config.format == "hybrid":
                self._fused_pipeline = HybridFusedPipeline(
                    self.word_ids, self.doc_ids, self.mask,
                    corpus=self.corpus, **kw)
            else:
                self._fused_pipeline = FusedPipeline(
                    self.word_ids, self.doc_ids, self.mask, **kw)
        return self._fused_pipeline

    def evaluate(self, state: LDAState) -> float:
        """LLPT of a dense state (a hybrid run hands its densified one)."""
        return float(llpt_mod.llpt(
            self.word_ids, self.doc_ids, self.mask, state.D, state.W,
            alpha=self.config.alpha_, beta=self.config.beta,
            tile_size=self.config.tile_size))

    # -- loops ------------------------------------------------------------

    def run_fused(self, n_iters: int, state: LDAState | None = None,
                  log_fn: Callable[[str], None] | None = None
                  ) -> tuple[LDAState, dict]:
        """Fused loop, chunked at the absolute eval boundaries."""
        state = self.init_state() if state is None else state
        pipe = self.fused_pipeline()
        carry = {"fs": pipe.from_lda_state(state)}

        def run_chunk(chunk):
            carry["fs"], stats, _ = pipe.run_fused(carry["fs"], chunk)
            _synchronize(self.device)
            return stats

        history = run_boundary_chunked(
            n_iters, int(state.iteration), n_tokens=self.n_real_tokens,
            eval_every=self.config.eval_every, run_chunk=run_chunk,
            evaluate=lambda: self.evaluate(pipe.to_lda_state(carry["fs"])),
            log_fn=log_fn)
        return pipe.to_lda_state(carry["fs"]), history

    def run(self, n_iters: int, state: LDAState | None = None,
            log_fn: Callable[[str], None] | None = None
            ) -> tuple[LDAState, dict]:
        if self.config.fused or self.config.format == "hybrid":
            return self.run_fused(n_iters, state, log_fn)
        state = self.init_state() if state is None else state
        history: dict[str, list] = {"iteration": [], "llpt": [],
                                    "tokens_per_sec": [], "stats": []}
        start_iter = int(state.iteration)
        for i in range(start_iter, start_iter + n_iters):
            t0 = time.perf_counter()
            state, stats = self.step(state)
            _synchronize(self.device)
            dt = time.perf_counter() - t0
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
        return state, history
