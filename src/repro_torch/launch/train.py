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

Without ``--lda`` it trains an LM of the zoo (``--arch``, any of the
ten: ``train_lm``) on the synthetic pipeline, on one device,
as the reference's launcher does; ``--full-config`` takes the published
width (on the card), else ``reduced_config``::

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --full-config \
        --steps 8 --seq-len 4096 --global-batch 4
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --device cpu

Its checkpoints hold the whole train state (see ``train_lm``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY
from repro_torch.models.tree import tree_from_items, tree_items, tree_map


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


def _train_payload(state: dict) -> dict:
    """The whole train state as NumPy arrays: ``master/<path>``,
    ``m/<path>``, ``v/<path>``, ``count`` and ``step``."""
    out = {"step": np.int64(int(state["step"])),
           "count": np.int32(int(state["opt"]["count"]))}
    for part in ("master", "m", "v"):
        for path, t in tree_items(state["opt"][part]):
            out[f"{part}/{path}"] = t.detach().cpu().numpy()
    return out


def _state_from_payload(payload: dict, like: dict, cfg, step: int) -> dict:
    """A train state shaped like ``like`` from ``_train_payload``'s
    arrays; params are the master cast to the param dtype, bitwise what
    ``adamw_update`` made of it."""
    opt = {}
    for part in ("master", "m", "v"):
        items = []
        for path, t in tree_items(like["opt"][part]):
            a = payload.get(f"{part}/{path}")
            if a is None:
                raise ValueError(
                    f"checkpoint step {step} holds no train state to resume "
                    f"from (keys: {sorted(payload)[:6]}); a payload of only "
                    "'step', as the reference's train_lm writes, would "
                    "resume fresh weights mid-schedule. Start in an empty "
                    "checkpoint directory")
            if a.shape != tuple(t.shape):
                raise ValueError(f"checkpoint step {step}: {part}/{path} is "
                                 f"{a.shape}, {cfg.name} needs "
                                 f"{tuple(t.shape)}")
            items.append((path, torch.from_numpy(a).to(t.device)))
        opt[part] = tree_from_items(items)
    dev = like["step"].device
    opt["count"] = torch.tensor(int(payload["count"]), dtype=torch.int32,
                                device=dev)
    params = tree_map(lambda w: w.to(cfg.dtype, copy=True), opt["master"])
    return {"params": params, "opt": opt,
            "step": torch.tensor(int(payload["step"]), dtype=torch.int32,
                                 device=dev)}


def train_lm(arch: str, *, steps: int = 200, seq_len: int = 256,
             global_batch: int = 8, reduced: bool = True,
             n_layers: int | None = None,
             checkpoint_dir: str | None = None, log_every: int = 10,
             lr: float = 3e-3, seed: int = 0, device=None,
             log_fn=print) -> dict:
    """LM pretraining on the synthetic pipeline, on one device (None: the
    CUDA card), with the reference's schedule (AdamW, warmup
    ``max(steps // 20, 5)``, cosine to ``steps``), its log line and its
    history ``{"step", "loss", "tokens_per_sec"}`` (a row every
    ``log_every`` steps and at the first step run); the history also
    holds the final train state under ``"state"``. ``n_layers`` cuts the
    depth (decoder layers) and keeps the width, for a published config
    whose train state one card cannot hold.

    With ``checkpoint_dir`` the whole train state is saved every 50 steps
    and the newest valid checkpoint is resumed: the float32 master, m and
    v, the count and the step (params are the master cast back), so a
    resumed run is bitwise the uninterrupted one. The reference saves
    only the step and resumes fresh weights (ROADMAP.md Queue 3); a
    payload without the train state raises ``ValueError`` here.
    """
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    cfg = REGISTRY[arch]
    if reduced:
        cfg = reduced_config(cfg)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    api = get_model(cfg, device)
    opt = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                      total_steps=steps)
    step_fn, init_state = make_train_step(api, n_micro=1, opt_cfg=opt)
    manager = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    state = init_state(seed)
    start = 0
    if manager is not None:
        payload = manager.restore_latest(log_fn=log_fn)
        if payload is not None:
            start = int(payload["step"])
            state = _state_from_payload(payload, state, cfg, start)
            log_fn(f"[train] resuming from step {start}")
    history = {"step": [], "loss": [], "tokens_per_sec": []}
    t0 = time.perf_counter()
    for i in range(start, steps):
        batch = {k: torch.from_numpy(v).to(api.device) for k, v in make_batch(
            cfg, seq_len, global_batch, "train", step=i, seed=seed).items()}
        state, metrics = step_fn(state, batch)
        if (i + 1) % log_every == 0 or i == start:
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            tps = (i + 1 - start) * seq_len * global_batch / dt
            history["step"].append(i + 1)
            history["loss"].append(loss)
            history["tokens_per_sec"].append(tps)
            log_fn(f"[train] step={i+1:5d} loss={loss:.4f}"
                   f" tok/s={tps:,.0f} lr={float(metrics['lr']):.2e}")
        if manager is not None and (i + 1) % 50 == 0:
            manager.save(i + 1, _train_payload(state))
    history["state"] = state
    return history


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
                         "instead of LM pretraining")
    ap.add_argument("--arch", choices=sorted(REGISTRY), default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config (on the card)")
    ap.add_argument("--lr", type=float, default=3e-3)
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
        hist = train_lm(args.arch, steps=args.steps, seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        reduced=not args.full_config,
                        checkpoint_dir=args.checkpoint_dir, lr=args.lr,
                        device=args.device)
        final = hist["loss"][-1] if hist["loss"] else float("nan")
        print(f"[train] done: final loss {final:.4f}")
        return 0
    distributed = args.lda_backend == "distributed"
    if distributed and "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            "repro_torch.launch.train: --lda-backend distributed runs one "
            "rank of a torchrun world (python -m torch.distributed.run "
            "--nproc-per-node N -m repro_torch.launch.train ...), which "
            "sets WORLD_SIZE, RANK and the rendezvous address")
    if distributed:
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
