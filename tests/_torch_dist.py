"""Process-group worlds for the port's distributed tests, on the CPU.

``run_world(n, scenario, args, tmp_path)`` starts ``n`` processes (the
``spawn`` start method, one thread each), joins them into one gloo group
through a ``file://`` rendezvous in ``tmp_path`` (never a fixed TCP port:
test workers run side by side), runs the module-level function
``scenario(rank, world, *args)`` on every rank and returns each rank's
result. A rank that raises writes its traceback and exits non-zero; the
parent joins every process with one deadline, kills what is left, and
fails the test with the tracebacks, so no test can hang on a
collective. ``world1(tmp_path)`` is a one-rank group in the test's own
process.

The worlds build their corpus from a seed: the reference's
``tests/test_distributed.py`` corpus (80 docs, 100 words), K = 16, tiles
of 512 tokens, shards padded to 256. This module imports ``torch`` and
``repro_torch`` only, never JAX, so the workers start quickly.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

GROUP_TIMEOUT = timedelta(seconds=60)
PAD = 256                      # pad_multiple of every distributed engine
BASE = dict(n_topics=16, tile_size=512, fused=True)


def make_corpus():
    from repro_torch.lda.corpus import (relabel_by_frequency,
                                        synthetic_lda_corpus)
    c = synthetic_lda_corpus(0, n_docs=80, n_words=100, n_topics=8,
                             mean_doc_len=50)
    return relabel_by_frequency(c)[0]


def make_config(**kw):
    from repro_torch.lda.model import DistConfig, LDAConfig
    balance = kw.pop("balance", "none")
    return LDAConfig(**{**BASE, **kw}, dist=DistConfig(balance=balance))


def summary(engine, hist) -> dict:
    """What a test compares: canonical topics, the global counts, every
    LLPT and stat of the history, and a few layout facts."""
    D, W = engine.trainer.gather_global(engine.state) \
        if engine.backend_name == "distributed" \
        else (engine.state.D, engine.state.W)
    out = {"topics": engine.host_payload()["topics_global"],
           "D": D.cpu().numpy(), "W": W.cpu().numpy(),
           "llpt": list(hist["llpt"]), "iterations": list(hist["iteration"]),
           "stats": list(hist["stats"]), "iteration": engine.iteration,
           "nbytes": engine.state_nbytes()}
    if engine.backend_name == "distributed":
        tr = engine.trainer
        out.update(n_shared=int(tr.n_shared), shard=tr.shard,
                   mesh=dict(tr.mesh.shape), coords=dict(tr.mesh.coords),
                   score=engine.score())
    return out


# -- running a world ----------------------------------------------------------

def _entry(rank: int, world: int, init: str, scenario: str, args: tuple,
           out_dir: str) -> None:
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    out = Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
        try:
            result = globals()[scenario](rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(out / f"{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_world(world: int, scenario: str, args: tuple, tmp_path: Path,
              timeout: float = 150.0) -> list:
    """Every rank's result of ``scenario`` in a gloo world of ``world``."""
    out = Path(tmp_path) / f"{scenario}-{world}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, str(out / "rdzv"), scenario, args,
                               str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = {r: (out / f"{r}.err").read_text() for r in range(world)
            if (out / f"{r}.err").exists()}
    codes = [p.exitcode for p in procs]
    if hung or errs or any(c != 0 for c in codes):
        raise AssertionError(
            f"world of {world} ({scenario}): exit codes {codes}, ranks "
            f"past the {timeout:.0f} s deadline {hung}\n"
            + "\n".join(f"--- rank {r} ---\n{e}" for r, e in errs.items()))
    results = []
    for r in range(world):
        with open(out / f"{r}.pkl", "rb") as f:   # written by our workers
            results.append(pickle.load(f))
    return results


@contextlib.contextmanager
def world1(tmp_path: Path):
    """A one-rank gloo group in this process, destroyed on exit."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv1",
                            rank=0, world_size=1, timeout=GROUP_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- the scenarios ------------------------------------------------------------

# (name, mesh shape, mesh axes, config knobs, iterations, eval_every)
WORLD4 = (
    ("dense_4x1", (4, 1), ("data", "model"), {}, 6, 1),
    ("tiles_4x1", (4, 1), ("data", "model"), dict(balance="tiles"), 6, 1),
    ("pod_2x2x1", (2, 2, 1), ("pod", "data", "model"), {}, 4, 2),
    ("dense_2x2", (2, 2), ("data", "model"), {}, 15, 5),
    # the topic-split sweep in chunks of 1,024 tokens: bitwise dense_2x2
    ("dense_2x2_chunked", (2, 2), ("data", "model"),
     dict(sweep_tokens=1024), 15, 5),
)
WORLD2 = (
    ("dense_2x1", (2, 1), ("data", "model"), {}, 6, 1),
    ("hybrid_2x1", (2, 1), ("data", "model"),
     dict(format="hybrid", tail_sampler="sparse"), 6, 1),
)
# (4,1) dense for this many iterations, then checkpointed: the payload
# the world of 2 restores elastically
ELASTIC_ITERS = 5


def _engine(corpus, name_cfg, mesh=None, **kw):
    from repro_torch.lda.api import LDAEngine
    return LDAEngine(corpus, name_cfg, device="cpu", backend="distributed",
                     mesh=mesh, pad_multiple=PAD, **kw)


def _run_cases(cases) -> dict:
    from repro_torch.runtime.sharding import ProcessMesh
    corpus, out = make_corpus(), {}
    for name, shape, axes, kw, iters, every in cases:
        kw = dict(kw)
        sweep = kw.pop("sweep_tokens", None)
        eng = _engine(corpus, make_config(eval_every=every, **kw),
                      ProcessMesh(shape, axes))
        if sweep:
            eng.trainer.sweep_tokens = sweep
        out[name] = summary(eng, eng.fit(iters))
    return out


def world4(rank: int, world: int, ckpt_dir: str) -> dict:
    """The (4,1), tiles, pod and (2,2) runs, and the elastic checkpoint."""
    out = _run_cases(WORLD4)
    eng = _engine(make_corpus(), make_config(), checkpoint_dir=ckpt_dir)
    eng.fit(ELASTIC_ITERS, checkpoint_every=ELASTIC_ITERS)
    out["elastic_saved"] = summary(eng, {"llpt": [], "iteration": [],
                                         "stats": []})
    return out


def _outcome(fn) -> tuple[str, str]:
    try:
        fn()
    except (ValueError, NotImplementedError, TypeError) as exc:
        return type(exc).__name__, str(exc)
    return "none", ""


def _rejections(corpus, tmp: str) -> dict:
    """Every refusal of the distributed backend, by name."""
    from repro_torch.lda.api import LDAEngine
    from repro_torch.lda.distributed import DistLDATrainer
    from repro_torch.lda.model import DistConfig, LDAConfig
    from repro_torch.runtime.sharding import ProcessMesh

    def mesh(*shape):
        return ProcessMesh(shape, ("data", "model"))

    cases = {
        "warp": lambda: _engine(corpus, make_config(sampler="warp")),
        "hybrid_model_axis": lambda: _engine(
            corpus, make_config(format="hybrid"), mesh(1, 2)),
        "hybrid_tiles": lambda: _engine(
            corpus, make_config(format="hybrid", balance="tiles")),
        "k_not_divisible": lambda: _engine(
            corpus, make_config(n_topics=15), mesh(1, 2)),
        "w_sync_ps": lambda: _engine(corpus, LDAConfig(
            **BASE, dist=DistConfig(w_sync="ps"))),
        "streamed": lambda: _engine(corpus, make_config(
            corpus_residency="streamed", stream_shards=2)),
        "disk": lambda: LDAEngine(None, LDAConfig(
            **BASE, corpus_residency="disk", corpus_path=tmp),
            device="cpu", backend="distributed"),
        "supervise": lambda: _engine(
            corpus, make_config(), checkpoint_dir=tmp).fit(
                1, supervise=True),
        "mesh_and_mesh_shape": lambda: _engine(corpus, LDAConfig(
            **BASE, dist=DistConfig(mesh_shape=(("data", 2), ("model", 1)))),
            mesh(2, 1)),
        "mesh_product": lambda: mesh(4, 1),
        "no_model_axis": lambda: DistLDATrainer(
            corpus, make_config(), ProcessMesh((2,), ("data",)),
            _from_engine=True),
        "direct_construction": lambda: DistLDATrainer(
            corpus, make_config(), mesh(2, 1)),
    }
    return {name: _outcome(fn) for name, fn in cases.items()}


def world2(rank: int, world: int, elastic_dir: str, ref_payload: str,
           out_dir: str) -> dict:
    """The (2,1) dense and hybrid runs, the elastic restore of the (4,1)
    checkpoint, ``backend="auto"``, the payload interchange and every
    rejection."""
    from repro_torch.lda.api import LDAEngine
    out = _run_cases(WORLD2)
    corpus = make_corpus()
    # elastic: the (4,1) checkpoint on a (2,1) mesh (the default mesh)
    eng = _engine(corpus, make_config(), checkpoint_dir=elastic_dir).resume()
    out["elastic_restored"] = summary(eng, {"llpt": [], "iteration": [],
                                            "stats": []})
    # the engine's own choice in a world of 2
    auto = LDAEngine(corpus, make_config(), device="cpu", pad_multiple=PAD)
    out["auto"] = {"backend": auto.backend_name,
                   "mesh": dict(auto.trainer.mesh.shape)}
    # a distributed checkpoint for the single engines of both packages
    eng = _engine(corpus, make_config(), checkpoint_dir=out_dir)
    eng.fit(3)
    out["saved_path"] = eng.save()
    out["saved"] = summary(eng, {"llpt": [], "iteration": [], "stats": []})
    # a reference single-engine payload restored here
    with np.load(ref_payload) as z:
        payload = {k: z[k] for k in z.files}
    eng = _engine(corpus, make_config()).restore(payload)
    out["ref_restored"] = summary(eng, {"llpt": [], "iteration": [],
                                        "stats": []})
    out["rejections"] = _rejections(corpus, out_dir + "-none")
    return out


def card_world(rank: int, world: int) -> dict:
    """On the card, over gloo: the collectives on CUDA tensors against
    their inputs, and a (world, 1) dense run (``tests/test_torch_cuda.py``)."""
    import torch
    from repro_torch.runtime.sharding import ProcessMesh
    torch.cuda.set_device(0)
    mesh = ProcessMesh((world, 1), ("data", "model"))
    g = torch.Generator().manual_seed(rank)
    xi = torch.randint(-1000, 1000, (1000, 7), generator=g, dtype=torch.int32)
    xf = torch.rand(513, generator=g)
    yi = mesh.psum(xi.cuda(), "data")
    yf = mesh.psum(xf.cuda(), ("data",))
    ga = mesh.all_gather(xi.cuda(), "data")
    out = {"xi": xi.numpy(), "xf": xf.numpy(), "psum_i": yi.cpu().numpy(),
           "psum_f": yf.cpu().numpy(), "gather": ga.cpu().numpy(),
           "on_card": bool(yi.is_cuda and yf.is_cuda and ga.is_cuda)}
    from repro_torch.lda.api import LDAEngine
    eng = LDAEngine(make_corpus(), make_config(eval_every=1), device="cuda",
                    backend="distributed", pad_multiple=PAD)
    out["dense"] = summary(eng, eng.fit(4))
    return out
