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
            result = _scenario(scenario)(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(out / f"{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def _scenario(name: str):
    """A scenario of this module, or ``"module:function"`` of another
    (imported by name in the worker)."""
    if ":" not in name:
        return globals()[name]
    import importlib
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)


def run_world(world: int, scenario: str, args: tuple, tmp_path: Path,
              timeout: float = 150.0) -> list:
    """Every rank's result of ``scenario`` in a gloo world of ``world``."""
    out = Path(tmp_path) / f"{scenario.replace(':', '.')}-{world}"
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

STREAMED = dict(corpus_residency="streamed")
# (name, mesh shape, mesh axes, config knobs, iterations, eval_every)
WORLD4 = (
    ("dense_4x1", (4, 1), ("data", "model"), {}, 6, 1),
    ("tiles_4x1", (4, 1), ("data", "model"), dict(balance="tiles"), 6, 1),
    ("pod_2x2x1", (2, 2, 1), ("pod", "data", "model"), {}, 4, 2),
    ("dense_2x2", (2, 2), ("data", "model"), {}, 15, 5),
    # the topic-split sweep in chunks of 1,024 tokens: bitwise dense_2x2
    ("dense_2x2_chunked", (2, 2), ("data", "model"),
     dict(sweep_tokens=1024), 15, 5),
    # streamed residency: each bitwise its resident run above
    ("streamed_dense_4x1", (4, 1), ("data", "model"),
     dict(STREAMED, stream_shards=3), 6, 1),
    ("streamed_tiles_4x1", (4, 1), ("data", "model"),
     dict(STREAMED, stream_shards=3, balance="tiles"), 6, 1),
    ("streamed_2x2", (2, 2), ("data", "model"),
     dict(STREAMED, stream_shards=3), 15, 5),
)
WORLD2 = (
    ("dense_2x1", (2, 1), ("data", "model"), {}, 6, 1),
    ("hybrid_2x1", (2, 1), ("data", "model"),
     dict(format="hybrid", tail_sampler="sparse"), 6, 1),
    ("streamed_dense_2x1", (2, 1), ("data", "model"),
     dict(STREAMED, stream_shards=2), 6, 1),
    ("streamed_hybrid_2x1", (2, 1), ("data", "model"),
     dict(STREAMED, stream_shards=3, format="hybrid",
          tail_sampler="sparse"), 6, 1),
)
# each streamed case and the resident case it must equal bit for bit
STREAMED_OF = {"streamed_dense_4x1": "dense_4x1",
               "streamed_tiles_4x1": "tiles_4x1",
               "streamed_2x2": "dense_2x2",
               "streamed_dense_2x1": "dense_2x1",
               "streamed_hybrid_2x1": "hybrid_2x1"}
# killed between the sub-shards of an epoch, then fit again to the end
KILLED_OF = "streamed_dense_2x1"
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


def _mid_epoch_payload(corpus) -> None:
    """A streamed run killed inside an epoch (the same sub-shard on every
    rank), then asked for a checkpoint payload: refused."""
    from repro_torch.runtime import chaos
    eng = _engine(corpus, make_config(**STREAMED, stream_shards=2))
    with chaos.active(chaos.FaultPlan(raise_at_shards=((1, 1),))):
        try:
            eng.fit(2)
        except chaos.InjectedFault:
            pass
    assert eng.state.cursor == 1
    eng.host_payload()


def _killed_and_resumed(corpus) -> dict:
    """``KILLED_OF``'s run killed at sub-shard 1 of iteration 1 (the same
    on every rank) and fit again for the iterations it had left: what the
    undisturbed run ends at."""
    from repro_torch.runtime import chaos
    (_, _, _, kw, iters, every), = [c for c in WORLD2 if c[0] == KILLED_OF]
    eng = _engine(corpus, make_config(eval_every=every, **kw))
    with chaos.active(chaos.FaultPlan(raise_at_shards=((1, 1),))):
        try:
            eng.fit(iters)
        except chaos.InjectedFault:
            pass
    assert (eng.iteration, eng.state.cursor) == (1, 1)
    return summary(eng, eng.fit(iters - 1))


def _outcome(fn) -> tuple[str, str]:
    try:
        fn()
    except (ValueError, NotImplementedError, TypeError) as exc:
        return type(exc).__name__, str(exc)
    return "none", ""


def _rejections(corpus, tmp: str) -> dict:
    """Every refusal of the distributed backend, by name."""
    from repro_torch.lda.api import LDAEngine, SupervisePolicy
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
        "streamed": lambda: _mid_epoch_payload(corpus),
        "streamed_step": lambda: (lambda e: e.trainer.step(
            e.trainer.init_state()))(_engine(corpus, make_config(
                **STREAMED, stream_shards=2))),
        "streamed_mid_epoch_restore": lambda: _engine(
            corpus, make_config(**STREAMED, stream_shards=2)).restore({
                "topics_global": np.zeros(corpus.n_tokens, np.int32),
                "iteration": 1, "stream_cursor": np.int64(1),
                "stream_done_topics": np.zeros(0, np.int32),
                "stream_n_shards": np.int64(2)}),
        "disk": lambda: LDAEngine(None, LDAConfig(
            **BASE, corpus_residency="disk", corpus_path=tmp),
            device="cpu", backend="distributed"),
        "supervise_shards_resident": lambda: _engine(
            corpus, make_config(), checkpoint_dir=tmp).fit(
                1, supervise=SupervisePolicy(checkpoint_shards=1)),
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
    checkpoint, ``backend="auto"``, the payload interchange, a streamed
    epoch resumed after a fault and every rejection."""
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
    # streamed: epoch-boundary payloads both ways with the resident trainer
    empty = {"llpt": [], "iteration": [], "stats": []}
    eng = _engine(corpus, make_config(**STREAMED, stream_shards=2),
                  checkpoint_dir=out_dir + "-streamed")
    eng.fit(3)
    eng.save()
    out["streamed_saved"] = summary(eng, empty)
    eng = _engine(corpus, make_config(),
                  checkpoint_dir=out_dir + "-streamed").resume()
    out["streamed_to_resident"] = summary(eng, empty)
    eng = _engine(corpus, make_config(**STREAMED, stream_shards=3),
                  checkpoint_dir=out_dir).resume()
    out["resident_to_streamed"] = summary(eng, empty)
    out["streamed_killed"] = _killed_and_resumed(corpus)
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


# -- the per-rank LLPT and the supervised replicated fit ---------------------

# (name, mesh shape, config knobs, iterations): run with gather_global
# raising, every LLPT and tripwire on the ranks' own rows
LLPT4 = (
    ("dense_4x1", (4, 1), dict(selfcheck=True), 3),
    ("tiles_4x1", (4, 1), dict(balance="tiles", selfcheck=True), 3),
    ("streamed_tiles_4x1", (4, 1),
     dict(STREAMED, stream_shards=3, balance="tiles", selfcheck=True), 3),
    ("dense_2x2", (2, 2), dict(selfcheck=True), 3),
    ("streamed_2x2", (2, 2), dict(STREAMED, stream_shards=3,
                                  selfcheck=True), 3),
)
LLPT2 = (
    ("dense_2x1", (2, 1), dict(selfcheck=True), 3),
    ("streamed_hybrid_2x1", (2, 1),
     dict(STREAMED, stream_shards=3, format="hybrid", tail_sampler="sparse",
          selfcheck=True), 3),
)
# (name, mesh shape, config knobs, iterations, faulted rank, fault plan
# knobs, SupervisePolicy knobs): each ends bitwise its plain run (the same
# mesh and knobs, unsupervised, no fault); an out-of-memory fault degrades
# every rank to streamed, which is bitwise resident
DRILLS2 = (
    ("raise_one_rank", (2, 1), {}, 5, 1, dict(raise_at_steps=(3,)),
     dict(checkpoint_every=2)),
    ("io_fault_sub_shard", (2, 1), dict(STREAMED, stream_shards=3), 3, 0,
     dict(io_fault_shards=(1,)), dict(checkpoint_shards=1)),
    ("oom_one_rank", (2, 1), {}, 5, 0, dict(oom_at_steps=(3,)),
     dict(checkpoint_every=2)),
)
DRILLS4 = (
    ("raise_tiles_4x1", (4, 1), dict(balance="tiles"), 4, 2,
     dict(raise_at_steps=(2,)), dict(checkpoint_every=1)),
    ("oom_2x2", (2, 2), dict(stream_shards=2), 4, 3,
     dict(oom_at_steps=(2,)), dict(checkpoint_every=1)),
)


@contextlib.contextmanager
def no_global_gather():
    """``DistLDATrainer.gather_global`` raising while the block runs."""
    from repro_torch.lda.distributed import DistLDATrainer
    keep = DistLDATrainer.gather_global

    def refuse(self, state):
        raise AssertionError("gather_global called during training")
    DistLDATrainer.gather_global = refuse
    try:
        yield
    finally:
        DistLDATrainer.gather_global = keep


def _tripwires(eng) -> dict:
    """The tripwire's verdicts on the live state and after one count of
    this rank's first D row (rank 0) or W replica (others) is moved."""
    from repro_torch.lda.invariants import InvariantViolation
    tr, st = eng.trainer, eng.state
    tr.selfcheck(st)
    D, W = tr.dense_rows(st)
    if tr.layout is not None:
        return {"clean": True}
    target = D if tr.mesh.rank == 0 else W
    target[0, 0] -= 1
    try:
        tr.selfcheck(st)
        tripped = None
    except InvariantViolation as exc:
        tripped = str(exc)
    target[0, 0] += 1
    return {"clean": True, "tripped": tripped}


def _llpt_cases(cases) -> dict:
    from repro_torch.runtime.sharding import ProcessMesh
    corpus, out = make_corpus(), {}
    for name, shape, kw, iters in cases:
        eng = _engine(corpus, make_config(eval_every=1, **kw),
                      ProcessMesh(shape, ("data", "model")))
        with no_global_gather():
            hist = eng.fit(iters)
            score = eng.score()
            trip = _tripwires(eng)
        out[name] = summary(eng, hist)
        out[name].update(score_no_gather=score, **trip)
    return out


def _drills(cases, rank: int, tmp: str) -> dict:
    from repro_torch.lda.api import SupervisePolicy
    from repro_torch.runtime import chaos
    from repro_torch.runtime.sharding import ProcessMesh
    corpus, out = make_corpus(), {}
    for name, shape, kw, iters, faulted, plan, pol in cases:
        mesh = ProcessMesh(shape, ("data", "model"))
        plain = _engine(corpus, make_config(eval_every=1, **kw), mesh)
        out[name + "/plain"] = summary(plain, plain.fit(iters))
        eng = _engine(corpus, make_config(eval_every=1, **kw), mesh,
                      checkpoint_dir=f"{tmp}/{name}")
        fault = chaos.active(chaos.FaultPlan(**plan)) if rank == faulted \
            else contextlib.nullcontext()
        t0 = time.monotonic()
        with fault, no_global_gather():
            hist = eng.fit(iters, supervise=SupervisePolicy(
                backoff_base=0.0, **pol))
        seconds = time.monotonic() - t0
        rep = hist.pop("restart_report")
        out[name] = summary(eng, hist)
        out[name].update(seconds=seconds, residency=eng.trainer.residency,
                         report={k: getattr(rep, k) for k in (
                             "completed_steps", "restarts", "resumed_from",
                             "faults", "straggler_steps", "elastic_reshards",
                             "degraded_to_streamed")})
    return out


def _fatal_on_one_rank(rank: int, tmp: str) -> str:
    """A fault that is not restartable on rank 1: that rank raises it,
    the others stop with ``RankAbort``, none waits out the group."""
    from repro_torch.lda.api import SupervisePolicy
    from repro_torch.runtime import chaos
    eng = _engine(make_corpus(), make_config(), checkpoint_dir=tmp)
    plan = chaos.FaultPlan(raise_at_steps=(1,), exc_factory=KeyError)
    with (chaos.active(plan) if rank == 1 else contextlib.nullcontext()):
        try:
            eng.fit(3, supervise=SupervisePolicy(backoff_base=0.0))
        except Exception as exc:        # noqa: BLE001 — the test reads it
            return f"{type(exc).__name__}: {exc}"
    return "none"


def _published(shape) -> dict:
    """Every rank's serving snapshots of a replicated fit (each chunk
    boundary, then the end) and of ``publish_serving``, without the global
    D, beside the run's summary."""
    from repro_torch.runtime.sharding import ProcessMesh
    eng = _engine(make_corpus(), make_config(eval_every=2),
                  ProcessMesh(shape, ("data", "model")))
    seen = []
    eng.subscribe(seen.append)
    with no_global_gather():
        eng.fit(4)
        eng.publish_serving()
    return {"snapshots": [(s.iteration, s.cursor, s.seq, s.W)
                          for s in seen],
            "run": summary(eng, {"llpt": [], "iteration": [], "stats": []})}


def supervise2(rank: int, world: int, tmp: str) -> dict:
    out = _llpt_cases(LLPT2)
    out.update(_drills(DRILLS2, rank, tmp))
    out["fatal"] = _fatal_on_one_rank(rank, f"{tmp}/fatal")
    out["published"] = _published((2, 1))
    return out


def supervise4(rank: int, world: int, tmp: str) -> dict:
    out = _llpt_cases(LLPT4)
    out.update(_drills(DRILLS4, rank, tmp))
    out["published"] = _published((2, 2))
    return out


def card_supervise(rank: int, world: int, ckpt: str) -> dict:
    """On the card, over gloo: a (world, 1) dense supervised fit with a
    step fault on rank 1 alone (``tests/test_torch_cuda.py``)."""
    import torch
    from repro_torch.lda.api import SupervisePolicy
    from repro_torch.runtime import chaos
    torch.cuda.set_device(0)
    eng = _engine_on_card(ckpt)
    fault = chaos.active(chaos.FaultPlan(raise_at_steps=(2,))) \
        if rank == 1 else contextlib.nullcontext()
    with fault, no_global_gather():
        hist = eng.fit(4, supervise=SupervisePolicy(checkpoint_every=1,
                                                    backoff_base=0.0))
    rep = hist.pop("restart_report")
    out = summary(eng, hist)
    out["report"] = (rep.restarts, rep.resumed_from, rep.faults)
    return out


def _engine_on_card(ckpt: str):
    from repro_torch.lda.api import LDAEngine
    return LDAEngine(make_corpus(), make_config(eval_every=1), device="cuda",
                     backend="distributed", pad_multiple=PAD,
                     checkpoint_dir=ckpt)
