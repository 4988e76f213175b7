"""Deterministic synthetic LM data pipeline: the port's NumPy copy of
``src/repro/data/synthetic.py``, which gives the same arrays bit for bit
for the same ``(seed, step)``.

Generates structured (not uniform-random) token streams so a ~100M model
actually has something to learn in a few hundred steps: a Zipf unigram
distribution mixed with first-order Markov bigram structure. Deterministic
in (seed, step) so restarts resume the exact stream — the data-side half of
elastic fault tolerance (no shuffle-state checkpointing needed).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticLM", "make_batch"]


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0, order: float = 1.2,
                 n_states: int = 64):
        self.vocab = vocab_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = ranks ** (-order)
        self.unigram /= self.unigram.sum()
        # low-rank bigram structure: hidden state chains
        self.n_states = n_states
        self.state_next = rng.integers(0, n_states, (n_states,))
        self.state_bias = rng.integers(0, vocab_size, (n_states,))

    def batch(self, step: int, batch: int, seq_len: int):
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.vocab, size=(batch, seq_len + 1),
                          p=self.unigram).astype(np.int32)
        # overwrite 50% of positions with deterministic state-chain tokens
        state = rng.integers(0, self.n_states, (batch,))
        for t in range(seq_len + 1):
            use = rng.random(batch) < 0.5
            det = (self.state_bias[state] + t) % self.vocab
            toks[use, t] = det[use]
            state = self.state_next[state]
        inputs = toks[:, :-1]
        labels = toks[:, 1:]
        mask = np.ones_like(inputs)
        return {"inputs": inputs, "labels": labels, "mask": mask}


def make_batch(cfg, seq_len: int, global_batch: int, kind: str,
               step: int = 0, seed: int = 0) -> dict:
    """Concrete numpy batch matching registry.input_specs (tests/examples)."""
    rng = np.random.default_rng((seed, step))
    b, s = global_batch, seq_len
    if cfg.is_encoder_decoder:
        sd = min(cfg.dec_len, s)
        out = {"frames": rng.normal(size=(b, s, cfg.d_model)
                                    ).astype(np.float32),
               "tokens": rng.integers(0, cfg.vocab_size, (b, sd)
                                      ).astype(np.int32),
               "labels": rng.integers(0, cfg.vocab_size, (b, sd)
                                      ).astype(np.int32),
               "mask": np.ones((b, sd), np.int32)}
        if kind == "prefill":
            return {"frames": out["frames"]}
        if kind == "decode":
            return {"tokens": out["tokens"][:, :1]}
        return out
    if cfg.input_is_embeddings:
        if kind == "decode":
            return {"tokens": rng.integers(0, cfg.vocab_size, (b, 1)
                                           ).astype(np.int32)}
        out = {"inputs": rng.normal(size=(b, s, cfg.d_model)
                                    ).astype(np.float32),
               "labels": rng.integers(0, cfg.vocab_size, (b, s)
                                      ).astype(np.int32),
               "mask": np.ones((b, s), np.int32)}
        return {"inputs": out["inputs"]} if kind == "prefill" else out
    if kind == "decode":
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, 1)
                                       ).astype(np.int32)}
    gen = SyntheticLM(cfg.vocab_size, seed=seed)
    out = gen.batch(step, b, s)
    return {"inputs": out["inputs"]} if kind == "prefill" else out
