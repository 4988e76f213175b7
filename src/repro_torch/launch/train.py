"""End-to-end training launcher of the port (one device, or one rank of a
process mesh under ``torchrun``).

Port of the ``--lda`` mode of ``src/repro/launch/train.py``: EZLDA
training through ``repro_torch.lda.api.LDAEngine`` on a planted-topic
synthetic corpus (``synthetic_lda_corpus``), checkpoint and restart via
``--checkpoint-dir``, and an optional serving export (``--lda-export``)
of the ``FrozenLDAModel``::

    python -m repro_torch.launch.train --lda --lda-topics 64 \\
        --checkpoint-dir ckpt --checkpoint-every 10 --lda-export model.npz

The command line runs on the CUDA card; ``--device cpu`` (or
``train_lda(device="cpu")``) runs the plain-PyTorch twins instead.

With ``--lda-backend distributed`` each process started by ``torchrun``
is one rank: the launcher initializes the default process group from
the environment ``torchrun`` sets (NCCL on the card, each rank on the
card of its ``LOCAL_RANK``; gloo with ``--device cpu``), trains the
distributed engine over ``--lda-mesh data,model`` (default: every rank on
the data axis), exports from rank 0, and destroys the group::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --lda --lda-backend distributed \
        --lda-mesh 2,1 --lda-export model.npz

The LM pretraining mode of the reference (``--arch``) is not ported yet
(ROADMAP.md Queue 1 #14): without ``--lda`` the launcher says so and
exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys


def train_lda(*, n_topics: int = 64, iters: int = 100, n_docs: int = 400,
              n_words: int = 800, mean_doc_len: int = 80,
              fmt: str = "dense", backend: str = "auto",
              balance: str = "none", mesh_shape: tuple = (),
              checkpoint_dir: str | None = None,
              checkpoint_every: int | None = None, eval_every: int = 10,
              seed: int = 0, export_path: str | None = None,
              device=None, log_fn=print) -> dict:
    """The --lda mode: EZLDA training through the engine.

    Builds a planted-topic synthetic corpus (the same one the reference
    builds for the same arguments), trains with the fused three-branch
    pipeline on the requested live-state format, and optionally exports
    the serving artifact. ``device=None`` means the CUDA card. On the
    distributed backend every rank of the initialized default group calls
    this, ``mesh_shape`` (``(("data", n), ("model", m))``, or () for all
    ranks on the data axis) lays them out, and rank 0 writes the export.
    Returns the engine's history dict.
    """
    from repro_torch.lda.api import LDAEngine
    from repro_torch.lda.corpus import synthetic_lda_corpus
    from repro_torch.lda.model import DistConfig, LDAConfig

    corpus = synthetic_lda_corpus(
        seed, n_docs=n_docs, n_words=n_words,
        n_topics=max(n_topics // 2, 2), mean_doc_len=mean_doc_len)
    cfg = LDAConfig(n_topics=n_topics, format=fmt, fused=True, seed=seed,
                    eval_every=eval_every,
                    dist=DistConfig(balance=balance, mesh_shape=mesh_shape))
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
        model = engine.export()              # on every rank: a collective
        if engine.backend_name == "single" or _rank() == 0:
            model.save(export_path)
            log_fn(f"[lda] serving artifact written to {export_path}")
    return hist


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_shape(text: str | None) -> tuple:
    """``"4,2"`` -> (("data", 4), ("model", 2)); None -> ()."""
    if not text:
        return ()
    try:
        n_data, n_model = (int(x) for x in text.split(","))
    except ValueError:
        raise SystemExit(f"--lda-mesh {text!r}: expected data,model "
                         "extents, e.g. 4,1") from None
    return (("data", n_data), ("model", n_model))


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
    ap.add_argument("--lda-backend",
                    choices=("auto", "single", "distributed"),
                    default="auto",
                    help="'distributed': one rank of a torchrun world "
                         "(the launcher initializes the process group)")
    ap.add_argument("--lda-mesh", default=None, metavar="DATA,MODEL",
                    help="the distributed mesh's extents (default: every "
                         "rank on the data axis)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch twins (gloo between ranks)")
    ap.add_argument("--lda-export", default=None, metavar="PATH",
                    help="write the FrozenLDAModel serving artifact here")
    args = ap.parse_args(argv)
    if not args.lda:
        print("repro_torch.launch.train: only the --lda mode is ported; LM "
              "pretraining arrives with ROADMAP.md Queue 1 #14",
              file=sys.stderr)
        return 2
    distributed = args.lda_backend == "distributed"
    if distributed and "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            "repro_torch.launch.train: --lda-backend distributed runs one "
            "rank of a torchrun world (python -m torch.distributed.run "
            "--nproc-per-node N -m repro_torch.launch.train ...), which "
            "sets WORLD_SIZE, RANK and the rendezvous address")
    if distributed:
        import torch
        import torch.distributed as dist
        if args.device == "cpu":
            dist.init_process_group("gloo")
        else:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group("nccl")
    try:
        log_fn = print if _rank() == 0 else (lambda _msg: None)
        hist = train_lda(n_topics=args.lda_topics, iters=args.lda_iters,
                         n_docs=args.lda_docs, n_words=args.lda_words,
                         fmt=args.lda_format, backend=args.lda_backend,
                         balance=args.lda_balance,
                         mesh_shape=_mesh_shape(args.lda_mesh),
                         checkpoint_dir=args.checkpoint_dir,
                         checkpoint_every=args.checkpoint_every,
                         export_path=args.lda_export, device=args.device,
                         log_fn=log_fn)
    finally:
        if distributed:
            dist.destroy_process_group()
    return 0 if hist["llpt"] and hist["llpt"][-1] >= hist["llpt"][0] else 1


if __name__ == "__main__":
    sys.exit(main())
