"""End-to-end training launcher of the port (one device).

Port of the ``--lda`` mode of ``src/repro/launch/train.py``: EZLDA
training through ``repro_torch.lda.api.LDAEngine`` on a planted-topic
synthetic corpus (``synthetic_lda_corpus``), checkpoint and restart via
``--checkpoint-dir``, and an optional serving export (``--lda-export``)
of the ``FrozenLDAModel``::

    python -m repro_torch.launch.train --lda --lda-topics 64 \\
        --checkpoint-dir ckpt --checkpoint-every 10 --lda-export model.npz

The command line runs on the CUDA card; ``train_lda(device="cpu")`` runs
the plain-PyTorch twins instead. The LM pretraining mode of the reference (``--arch``) is not
ported yet (ROADMAP.md Queue 1 #14): without ``--lda`` the launcher says
so and exits non-zero.
"""

from __future__ import annotations

import argparse
import sys


def train_lda(*, n_topics: int = 64, iters: int = 100, n_docs: int = 400,
              n_words: int = 800, mean_doc_len: int = 80,
              fmt: str = "dense", backend: str = "auto",
              balance: str = "none",
              checkpoint_dir: str | None = None,
              checkpoint_every: int | None = None, eval_every: int = 10,
              seed: int = 0, export_path: str | None = None,
              device=None, log_fn=print) -> dict:
    """The --lda mode: EZLDA training through the engine.

    Builds a planted-topic synthetic corpus (the same one the reference
    builds for the same arguments), trains with the fused three-branch
    pipeline on the requested live-state format, and optionally exports
    the serving artifact. ``device=None`` means the CUDA card. Returns
    the engine's history dict.
    """
    from repro_torch.lda.api import LDAEngine
    from repro_torch.lda.corpus import synthetic_lda_corpus
    from repro_torch.lda.model import LDAConfig

    corpus = synthetic_lda_corpus(
        seed, n_docs=n_docs, n_words=n_words,
        n_topics=max(n_topics // 2, 2), mean_doc_len=mean_doc_len)
    cfg = LDAConfig(n_topics=n_topics, format=fmt, fused=True, seed=seed,
                    eval_every=eval_every, balance=balance)
    engine = LDAEngine(corpus, cfg, device, backend=backend,
                       checkpoint_dir=checkpoint_dir)
    log_fn(f"[lda] {corpus.n_docs} docs / {corpus.n_words} words / "
           f"{corpus.n_tokens} tokens, K={n_topics}, format={fmt}, "
           f"backend={engine.backend_name}, device={engine.device}")
    hist = engine.fit(iters, log_fn=lambda s: log_fn("[lda] " + s),
                      checkpoint_every=checkpoint_every)
    if hist["llpt"]:
        log_fn(f"[lda] done: llpt {hist['llpt'][0]:+.4f} -> "
               f"{hist['llpt'][-1]:+.4f} at iter {engine.iteration} "
               f"(live state {engine.state_nbytes():,} B)")
    else:
        log_fn(f"[lda] done: no iterations run (iter {engine.iteration})")
    if export_path:
        engine.export().save(export_path)
        log_fn(f"[lda] serving artifact written to {export_path}")
    return hist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lda", action="store_true",
                    help="run EZLDA topic-model training via LDAEngine "
                         "(the only mode ported so far)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--lda-topics", type=int, default=64)
    ap.add_argument("--lda-iters", type=int, default=100)
    ap.add_argument("--lda-docs", type=int, default=400)
    ap.add_argument("--lda-words", type=int, default=800)
    ap.add_argument("--lda-format", choices=("dense", "hybrid"),
                    default="dense")
    ap.add_argument("--lda-balance", choices=("none", "tiles"),
                    default="none",
                    help="tile-scheduled workload balancing; a pure "
                         "performance knob, bit-equal")
    ap.add_argument("--lda-backend", choices=("auto", "single"),
                    default="auto",
                    help="the distributed backend is not ported yet "
                         "(ROADMAP.md Queue 1 #12)")
    ap.add_argument("--lda-export", default=None, metavar="PATH",
                    help="write the FrozenLDAModel serving artifact here")
    args = ap.parse_args(argv)
    if not args.lda:
        print("repro_torch.launch.train: only the --lda mode is ported; LM "
              "pretraining arrives with ROADMAP.md Queue 1 #14",
              file=sys.stderr)
        return 2
    hist = train_lda(n_topics=args.lda_topics, iters=args.lda_iters,
                     n_docs=args.lda_docs, n_words=args.lda_words,
                     fmt=args.lda_format, backend=args.lda_backend,
                     balance=args.lda_balance,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every,
                     export_path=args.lda_export)
    return 0 if hist["llpt"] and hist["llpt"][-1] >= hist["llpt"][0] else 1


if __name__ == "__main__":
    sys.exit(main())
