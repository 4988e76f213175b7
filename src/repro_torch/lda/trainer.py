"""Single-device LDA trainer: sample -> update -> eval loop.

Port of the dense part of ``src/repro/lda/trainer.py``. Two execution
modes share one state:

  * ``step()``: the stepwise oracle — the exact sampler over every token
    (``kernels.ops.sample_tokens`` for ``impl="kernel"``,
    ``core.three_branch.sample`` for ``impl="torch"``), then a full count
    rebuild;
  * ``run_fused()`` (and ``run()`` with ``config.fused``): the fused
    pipeline of ``train/lda_step.py`` — phase-1 skip, survivor chunks,
    ±1 delta updates.

Both draw iteration ``i``'s uniforms from the same generator, so they
produce identical topics and counts. With ``format="hybrid"`` the live
state exists only inside the fused pipeline (``HybridFusedPipeline``), so
``run()`` takes the fused loop whatever ``config.fused`` says, as the
reference does; ``step()`` stays the dense oracle.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import esca, llpt as llpt_mod, three_branch
from repro_torch.kernels import ops as kops
from repro_torch.lda.corpus import Corpus, pad_corpus
from repro_torch.lda.model import LDAConfig, LDAState, uniforms_generator
from repro_torch.runtime.device import resolve_device
from repro_torch.train.lda_step import (FusedPipeline, HybridFusedPipeline,
                                        draw_uniforms)

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
        self.plan = three_branch.build_plan(config)
        self._fused_pipeline: FusedPipeline | None = None

    # -- state ------------------------------------------------------------

    def init_state(self) -> LDAState:
        topics, D, W = esca.init_counts(
            uniforms_generator(self.config.seed, 0, self.device),
            self.word_ids, self.doc_ids, self.mask, n_docs=self.n_docs,
            n_words=self.n_words, n_topics=self.config.n_topics)
        return LDAState(topics=topics, D=D, W=W, iteration=0)

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
        D, W = esca.update_counts(
            self.word_ids, self.doc_ids, topics, self.mask,
            n_docs=self.n_docs, n_words=self.n_words,
            n_topics=self.config.n_topics)
        return LDAState(topics=topics, D=D, W=W, iteration=int(iteration))

    # -- steps ------------------------------------------------------------

    def step(self, state: LDAState) -> tuple[LDAState, dict]:
        """The stepwise oracle: exact sampler on every token + rebuild."""
        cfg = self.config
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
        D, W = esca.update_counts(
            self.word_ids, self.doc_ids, new_topics, self.mask,
            n_docs=self.n_docs, n_words=self.n_words, n_topics=cfg.n_topics)
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
