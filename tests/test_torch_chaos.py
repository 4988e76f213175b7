"""The failure model's drills: the port's supervised ``fit`` against the
reference's, under the same ``FaultPlan``.

Every CPU drill of ``tests/test_chaos.py`` (the forged multi-device one
waits for the port's distributed backend) runs here on the reference
engine and on the port's, on the same corpus (50 docs, 60 words, K = 8,
tiles of 256), the same config, the same plan and the same policy. The
two ``RestartReport``s must agree: restarts, where each attempt resumed,
completed steps, the degrade, the fault types and the straggler steps.
The port's final state must be bitwise its own uninterrupted run; the two
packages draw different random streams by design, so their states are
not compared with each other. A port's supervised directory, mid-epoch
checkpoints included, restores in the reference engine.

Wall-clock noise must not decide a drill: outside the straggler drill the
policies set ``straggler_z`` out of reach, so both reports carry no
straggler steps; the straggler drill slows one step by half a second and
both packages must flag it.
"""

import contextlib
import time
import warnings

import numpy as np
import pytest
import torch

from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.api import SupervisePolicy as JaxPolicy
from repro.lda.corpus import relabel_by_frequency, synthetic_lda_corpus
from repro.lda.corpus import shard_stream as jax_shard_stream
from repro.lda import invariants as jax_inv
from repro.lda.model import LDAConfig as JaxConfig
from repro.runtime import chaos as jax_chaos
from repro_torch.lda import LDAConfig, LDAEngine, invariants
from repro_torch.lda.api import RestartReport, SupervisePolicy
from repro_torch.lda.corpus import shard_stream
from repro_torch.runtime import chaos
from repro_torch.train import lda_step
from repro_torch.train.lda_step import PrefetchTimeout, _Prefetcher
from _torch_parity import port_corpus

pytestmark = pytest.mark.chaos

KEYS = ("topics_global", "key", "iteration")
NO_NOISE = 1e9          # straggler_z no wall-clock jitter reaches


@pytest.fixture(scope="module")
def corpora():
    c = synthetic_lda_corpus(7, n_docs=50, n_words=60, n_topics=6,
                             mean_doc_len=25)
    c, _ = relabel_by_frequency(c)
    return c, port_corpus(c)


def _kw(**kw):
    kw.setdefault("n_topics", 8)
    kw.setdefault("tile_size", 256)
    kw.setdefault("eval_every", 4)
    kw.setdefault("seed", 3)
    return kw


def _policy(**kw):
    kw.setdefault("checkpoint_every", 3)
    kw.setdefault("backoff_base", 0.0)
    kw.setdefault("straggler_z", NO_NOISE)
    return kw


def _same(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in KEYS)


def _port_ref(port_c, n, **kw):
    e = LDAEngine(port_c, LDAConfig(**_kw(**kw)), device="cpu")
    e.fit(n)
    return e.host_payload()


def _stores(corpora, tmp_path):
    """The same 4-shard stream written by each package."""
    c, pc = corpora
    js = jax_shard_stream(c, 4, multiple=256).to_store(str(tmp_path / "js"))
    ps = shard_stream(pc, 4, multiple=256).to_store(str(tmp_path / "ps"))
    return dict(corpus_residency="disk", corpus_path=js.path), \
        dict(corpus_residency="disk", corpus_path=ps.path)


def _drill(corpora, tmp_path, n, plan, policy, cfg, port_cfg=None,
           disk=False):
    """The same supervised ``fit(n)`` under the same plan in both
    packages; returns (reference history, port history, port engine)."""
    c, pc = corpora
    out = []
    for pkg, (Engine, Config, Policy, ch) in enumerate((
            (JaxEngine, JaxConfig, JaxPolicy, jax_chaos),
            (LDAEngine, LDAConfig, SupervisePolicy, chaos))):
        kw = dict(backend="single") if pkg == 0 else dict(device="cpu")
        conf = Config(**_kw(**(cfg if pkg == 0 or port_cfg is None
                               else port_cfg)))
        e = Engine(None if disk else (c, pc)[pkg], conf,
                   checkpoint_dir=str(tmp_path / f"ck{pkg}"), **kw)
        with ch.active(ch.FaultPlan(**plan)):
            out.append(e.fit(n, supervise=Policy(**policy)))
    return out[0], out[1], e


def _fault_types(rep):
    return [f.split(":")[0] for f in rep.faults]


def _assert_reports_agree(want, got):
    assert isinstance(got, RestartReport)
    for f in ("restarts", "resumed_from", "completed_steps",
              "degraded_to_streamed", "straggler_steps",
              "elastic_reshards"):
        assert getattr(got, f) == getattr(want, f), f
    assert _fault_types(got) == _fault_types(want)
    assert len(got.recovery_seconds) == len(want.recovery_seconds)


def _history_agrees(want, got):
    assert got["iteration"] == want["iteration"]
    assert len(got["llpt"]) == len(want["llpt"])
    assert all(np.isfinite(got["llpt"]))


# -- supervised restart -> bitwise the uninterrupted run ----------------------

@pytest.mark.parametrize("format", ["dense", "hybrid"])
def test_killed_at_step_resident(corpora, tmp_path, format):
    hr, hp, e = _drill(corpora, tmp_path, 10,
                       dict(raise_at_steps=(7,)), _policy(),
                       dict(format=format))
    rep = hp["restart_report"]
    _assert_reports_agree(hr["restart_report"], rep)
    _history_agrees(hr, hp)
    assert rep.restarts == 1 and rep.completed_steps == 10
    assert rep.resumed_from == [6] and "InjectedFault" in rep.faults[0]
    assert e.restart_report is rep
    assert _same(_port_ref(corpora[1], 10, format=format), e.host_payload())


@pytest.mark.parametrize("format", ["dense", "hybrid"])
def test_mid_epoch_kill_streamed(corpora, tmp_path, format):
    cfg = dict(format=format, corpus_residency="streamed", stream_shards=4)
    hr, hp, e = _drill(corpora, tmp_path, 8,
                       dict(raise_at_shards=((5, 2),)),
                       _policy(checkpoint_shards=1), cfg)
    rep = hp["restart_report"]
    _assert_reports_agree(hr["restart_report"], rep)
    _history_agrees(hr, hp)
    assert rep.restarts == 1 and rep.resumed_from == [5]
    assert _same(_port_ref(corpora[1], 8, **cfg), e.host_payload())


@pytest.mark.parametrize("case,want", [
    # fused: a first chunk of one iteration, then chunks to each boundary
    ("plain", [(1, 1), (4, 3), (5, 1)]),
    # fused, killed at step 3, the chunk after the checkpoint at 3: the
    # attempt restored at 3 starts its own chunks
    ("boundary", [(1, 1), (3, 2), (4, 1), (5, 1)]),
    # the stepwise loop, killed at step 2 before any checkpoint: the
    # replay from the start reports its steps again
    ("stepwise", [(1, 1), (2, 1), (1, 1), (2, 1), (3, 1), (4, 1), (5, 1)]),
    # one chunk an epoch; the killed epoch reports once, when its resumed
    # attempt closes it
    ("shardwise", [(1, 1), (2, 1), (3, 1), (4, 1), (5, 1)]),
])
def test_fit_on_chunk_reports_every_chunk(corpora, tmp_path, case, want):
    """``fit(on_chunk=)`` sees each chunk that ran, its size and a wall
    time, on the plain path and on every supervised attempt."""
    cfg, kw, plan = dict(fused=True), {}, None
    if case == "boundary":
        kw = dict(supervise=SupervisePolicy(**_policy()))
        plan = chaos.FaultPlan(raise_at_steps=(3,))
    if case == "stepwise":
        cfg = {}
        kw = dict(supervise=SupervisePolicy(**_policy()))
        plan = chaos.FaultPlan(raise_at_steps=(2,))
    if case == "shardwise":
        cfg = dict(corpus_residency="streamed", stream_shards=4)
        kw = dict(supervise=SupervisePolicy(**_policy(checkpoint_shards=1)))
        plan = chaos.FaultPlan(raise_at_shards=((2, 2),))
    e = LDAEngine(corpora[1], LDAConfig(**_kw(**cfg)), device="cpu",
                  checkpoint_dir=str(tmp_path / "ck"))
    seen = []
    with chaos.active(plan) if plan is not None else \
            contextlib.nullcontext():
        e.fit(5, on_chunk=lambda it, chunk, dt: seen.append((it, chunk,
                                                             dt)), **kw)
    assert [(it, chunk) for it, chunk, _ in seen] == want
    assert all(dt > 0 for *_, dt in seen)
    if plan is not None:
        assert e.restart_report.restarts == 1


def test_invariant_violation_is_restartable(corpora, tmp_path):
    """A tripped invariant restarts from the newest checkpoint; the same
    violation type goes to both packages."""
    c, pc = corpora
    reps = []
    for pkg, inv in enumerate((jax_inv, invariants)):
        ch = (jax_chaos, chaos)[pkg]
        plan = ch.FaultPlan(raise_at_steps=(5,), exc_factory=lambda m, inv=inv:
                            inv.InvariantViolation("injected", "chaos hook",
                                                   m))
        e = (JaxEngine(c, JaxConfig(**_kw()), backend="single",
                       checkpoint_dir=str(tmp_path / "r")) if pkg == 0 else
             LDAEngine(pc, LDAConfig(**_kw()), device="cpu",
                       checkpoint_dir=str(tmp_path / "p")))
        with ch.active(plan):
            reps.append(e.fit(8, supervise=(JaxPolicy, SupervisePolicy)[pkg](
                **_policy()))["restart_report"])
    _assert_reports_agree(*reps)
    assert reps[1].restarts == 1 and "InvariantViolation" in reps[1].faults[0]
    assert _same(_port_ref(pc, 8), e.host_payload())


def test_restore_walks_past_a_torn_newest_checkpoint(corpora, tmp_path):
    """The fault also tears the newest checkpoint file: the restart walks
    back to the one before it (told through ``log_fn``) and still ends
    bitwise, in both packages alike."""
    c, pc = corpora
    reps, logs = [], []
    for pkg in (0, 1):
        ch = (jax_chaos, chaos)[pkg]
        d = tmp_path / f"ck{pkg}"

        def tear_newest(msg, d=d, ch=ch):
            newest = sorted(d.glob("step_*.npz"))[-1]
            newest.write_bytes(newest.read_bytes()[:100])
            return ch.InjectedFault(msg)

        e = (JaxEngine(c, JaxConfig(**_kw()), backend="single",
                       checkpoint_dir=str(d)) if pkg == 0 else
             LDAEngine(pc, LDAConfig(**_kw()), device="cpu",
                       checkpoint_dir=str(d)))
        log = []
        with ch.active(ch.FaultPlan(raise_at_steps=(7,),
                                    exc_factory=tear_newest)):
            reps.append(e.fit(10, log_fn=log.append, supervise=(
                JaxPolicy, SupervisePolicy)[pkg](**_policy()))[
                "restart_report"])
        logs.append([m for m in log if "walking back" in m])
    _assert_reports_agree(*reps)
    assert reps[1].resumed_from == [3]
    assert logs[1] == logs[0] and len(logs[1]) == 1
    assert _same(_port_ref(pc, 10), e.host_payload())


# -- errors that must propagate -------------------------------------------------

def test_supervise_needs_manager(corpora):
    with pytest.raises(ValueError, match="checkpoint"):
        LDAEngine(corpora[1], LDAConfig(**_kw()), device="cpu").fit(
            4, supervise=True)


def test_checkpoint_shards_needs_streamed_single(corpora, tmp_path):
    e = LDAEngine(corpora[1], LDAConfig(**_kw()), device="cpu",
                  checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="streamed"):
        e.fit(4, supervise=SupervisePolicy(**_policy(checkpoint_shards=1)))


@pytest.mark.parametrize("case", ["max_restarts", "not_restartable",
                                  "second_oom"])
def test_faults_past_the_policy_propagate_in_both(corpora, tmp_path, case):
    """The restart budget bounds a repeating fault, a type outside
    ``restartable`` is not absorbed, and the OOM degrade happens once."""
    c, pc = corpora
    cfg, pol = {}, _policy()
    if case == "max_restarts":
        plan, pol = dict(raise_at_steps=(2,), repeat=True), \
            _policy(max_restarts=2)
    elif case == "not_restartable":
        plan = dict(raise_at_steps=(2,),
                    exc_factory=lambda m: KeyboardInterrupt(m))
    else:
        plan, pol = dict(oom_at_steps=(2,), repeat=True), \
            _policy(max_restarts=1)
        cfg = dict(corpus_residency="streamed", stream_shards=4)
    raised = []
    for pkg in (0, 1):
        ch = (jax_chaos, chaos)[pkg]
        e = (JaxEngine(c, JaxConfig(**_kw(**cfg)), backend="single",
                       checkpoint_dir=str(tmp_path / "r")) if pkg == 0 else
             LDAEngine(pc, LDAConfig(**_kw(**cfg)), device="cpu",
                       checkpoint_dir=str(tmp_path / "p")))
        with ch.active(ch.FaultPlan(**plan)), \
                pytest.raises(BaseException) as info:
            e.fit(6, supervise=(JaxPolicy, SupervisePolicy)[pkg](**pol))
        raised.append(type(info.value).__name__)
    assert raised[1] == raised[0] == {
        "max_restarts": "InjectedFault", "not_restartable":
        "KeyboardInterrupt", "second_oom": "SimulatedOOM"}[case]


# -- transient faults absorbed in place, persistent ones restarted -------------

STREAM_FAULTS = [
    # (plan, restarts, fault type): shard 0 loads inline, past the retries
    (dict(io_fault_shards=(1,), io_fault_attempts=1), 0, None),
    (dict(io_fault_shards=(0,), io_fault_attempts=1), 1, "OSError"),
    (dict(corrupt_shards=(2,), corrupt_attempts=1), 0, None),
    (dict(corrupt_shards=(0,), corrupt_attempts=1), 1,
     "ShardCorruptionError")]
STREAM_IDS = ["io_prefetched", "io_inline", "corrupt_prefetched",
              "corrupt_inline"]


@pytest.mark.parametrize("plan,restarts,kind", STREAM_FAULTS, ids=STREAM_IDS)
def test_streamed_shard_faults(corpora, tmp_path, plan, restarts, kind):
    cfg = dict(corpus_residency="streamed", stream_shards=4)
    hr, hp, e = _drill(corpora, tmp_path, 6, plan, _policy(), cfg)
    rep = hp["restart_report"]
    _assert_reports_agree(hr["restart_report"], rep)
    assert rep.restarts == restarts
    if kind is not None:
        assert _fault_types(rep) == [kind]
    if kind == "ShardCorruptionError":
        assert "crc32" in rep.faults[0]
    assert _same(_port_ref(corpora[1], 6, **cfg), e.host_payload())


DISK_FAULTS = [
    (dict(io_fault_shards=(1,), io_fault_attempts=1), 0, None),
    # 5 failing attempts: one round of 3 exhausted (a restart), then 2 of
    # the next round's 3 fail and the third reads
    (dict(io_fault_shards=(1,), io_fault_attempts=5), 1, "OSError"),
    (dict(corrupt_shards=(2,), corrupt_attempts=1), 0, None),
    (dict(corrupt_shards=(0,), corrupt_attempts=1), 1,
     "ShardCorruptionError")]
DISK_IDS = ["io_retried", "io_persistent", "corrupt_retried",
            "corrupt_inline"]


@pytest.mark.parametrize("plan,restarts,kind", DISK_FAULTS, ids=DISK_IDS)
def test_disk_shard_faults(corpora, tmp_path, plan, restarts, kind):
    jcfg, pcfg = _stores(corpora, tmp_path)
    hr, hp, e = _drill(corpora, tmp_path, 6, plan, _policy(), jcfg,
                       port_cfg=pcfg, disk=True)
    rep = hp["restart_report"]
    _assert_reports_agree(hr["restart_report"], rep)
    assert rep.restarts == restarts
    if kind is not None:
        assert _fault_types(rep) == [kind] and (
            kind == "OSError" or "crc32" in rep.faults[0])
    assert _same(_port_ref(corpora[1], 6), e.host_payload())


@pytest.mark.parametrize("format", ["dense", "hybrid"])
def test_disk_mid_epoch_kill_shardwise(corpora, tmp_path, format):
    jcfg, pcfg = _stores(corpora, tmp_path)
    hr, hp, e = _drill(corpora, tmp_path, 8,
                       dict(raise_at_shards=((5, 2),)),
                       _policy(checkpoint_shards=1),
                       dict(jcfg, format=format),
                       port_cfg=dict(pcfg, format=format), disk=True)
    rep = hp["restart_report"]
    _assert_reports_agree(hr["restart_report"], rep)
    assert rep.restarts == 1 and rep.resumed_from == [5]
    assert _same(_port_ref(corpora[1], 8, format=format), e.host_payload())


def test_corrupt_arrays_never_touches_the_backing_store(corpora):
    """The bit flip lands in a copy: the ShardedCorpus the in-memory slices
    share memory with stays clean, so a retry reloads good bytes."""
    e = LDAEngine(corpora[1], LDAConfig(**_kw(corpus_residency="streamed",
                                                stream_shards=4)),
                  device="cpu")
    pipe = e.trainer.fused_pipeline()
    before = [a.copy() for a in pipe._read_slices(0)]
    with chaos.active(chaos.FaultPlan(corrupt_shards=(0,))):
        with pytest.raises(invariants.ShardCorruptionError, match="crc32"):
            pipe._load_shard_slices(0)
        got = pipe._load_shard_slices(0)        # the next attempt: clean
    for a, b, c in zip(before, pipe._read_slices(0), got):
        assert np.array_equal(a, b) and np.array_equal(a, c)


# -- graceful degradation -------------------------------------------------------

def test_oom_degrades_resident_to_streamed(corpora, tmp_path):
    """An injected out-of-memory fault on the resident path: one degrade to
    streamed residency (with a warning), then bitwise convergence."""
    cfg = dict(corpus_residency="full", stream_shards=4)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        hr, hp, e = _drill(corpora, tmp_path, 8, dict(oom_at_steps=(5,)),
                           _policy(), cfg)
    rep = hp["restart_report"]
    _assert_reports_agree(hr["restart_report"], rep)
    assert rep.degraded_to_streamed and rep.restarts == 1
    assert "RESOURCE_EXHAUSTED" in rep.faults[0]
    assert e.config.corpus_residency == "streamed"
    assert e.trainer.residency == "streamed"
    assert e.trainer.n_stream_shards == 4
    degrades = [w for w in rec if issubclass(w.category, RuntimeWarning)
                and "streamed" in str(w.message)]
    assert len(degrades) == 2          # one from each package
    assert _same(_port_ref(corpora[1], 8, **cfg), e.host_payload())


# -- straggler detection ----------------------------------------------------------

def test_slow_step_flagged_as_straggler(corpora, tmp_path):
    """A step slowed by 0.5 s is flagged by both; ``on_chunk`` reports the
    step after it."""
    hr, hp, e = _drill(corpora, tmp_path, 16, dict(slow_steps={14: 0.5}),
                       _policy(straggler_window=16, straggler_z=4.0),
                       dict(eval_every=1))
    for rep in (hr["restart_report"], hp["restart_report"]):
        assert rep.restarts == 0
        assert 15 in rep.straggler_steps
        assert rep.timer_summary["n"] >= 16


# -- selfcheck on clean runs ------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(), dict(format="hybrid"),
    dict(corpus_residency="streamed", stream_shards=4),
    dict(format="hybrid", corpus_residency="streamed", stream_shards=4),
    dict(sampler="warp", fused=True), dict(fused=True)],
    ids=["dense_stepwise", "hybrid", "streamed", "streamed_hybrid", "warp",
         "dense_fused"])
def test_selfcheck_clean_runs_are_bitwise_unchecked_runs(corpora, cfg):
    """The tripwires draw no random number and change no chunking."""
    e = LDAEngine(corpora[1], LDAConfig(**_kw(selfcheck=True, **cfg)),
                  device="cpu")
    h = e.fit(4)
    off = LDAEngine(corpora[1], LDAConfig(**_kw(**cfg)), device="cpu")
    assert off.fit(4)["llpt"] == h["llpt"]
    assert e.iteration == 4 and _same(off.host_payload(), e.host_payload())


def test_selfcheck_disk_clean_run(corpora, tmp_path):
    _, pcfg = _stores(corpora, tmp_path)
    e = LDAEngine(None, LDAConfig(**_kw(selfcheck=True, **pcfg)),
                  device="cpu")
    e.fit(4)
    assert _same(_port_ref(corpora[1], 4), e.host_payload())


# -- a port's supervised directory restores in the reference --------------------

def test_reference_restores_a_port_supervised_directory(corpora, tmp_path):
    """Step keys it·(S+1)+cursor: the reference engine's restore picks the
    port's newest checkpoint, mid-epoch (a run killed past its budget) and
    at the end of a run, and holds the port's topics."""
    c, pc = corpora
    cfg = _kw(corpus_residency="streamed", stream_shards=4)
    d = str(tmp_path / "ck")
    e = LDAEngine(pc, LDAConfig(**cfg), device="cpu", checkpoint_dir=d)
    with chaos.active(chaos.FaultPlan(raise_at_shards=((5, 2),))), \
            pytest.raises(chaos.InjectedFault):
        e.fit(8, supervise=SupervisePolicy(**_policy(checkpoint_shards=1,
                                                     max_restarts=0)))
    port_mid = e.host_payload()
    assert int(port_mid["stream_cursor"]) == 2
    ref = JaxEngine(c, JaxConfig(**cfg), backend="single",
                    checkpoint_dir=d).resume()
    got = ref.host_payload()
    assert int(got["iteration"]) == 5 and int(got["stream_cursor"]) == 2
    for k in ("topics_global", "stream_done_topics"):
        assert np.array_equal(np.asarray(got[k]), port_mid[k]), k

    # a fresh engine resumes the open epoch and ends the run at 8
    e = LDAEngine(pc, LDAConfig(**cfg), device="cpu", checkpoint_dir=d)
    h = e.fit(3, supervise=SupervisePolicy(**_policy(checkpoint_shards=1)))
    assert h["restart_report"].resumed_from == [5] and e.iteration == 8
    ref = JaxEngine(c, JaxConfig(**cfg), backend="single",
                    checkpoint_dir=d).resume()
    assert _same(ref.host_payload(), e.host_payload())
    assert _same(_port_ref(pc, 8, **cfg), e.host_payload())


# -- the prefetcher, the watchdog, the residency warning -------------------------

def test_prefetcher_close_suppresses_pending_failure():
    p = _Prefetcher(retries=0)

    def boom():
        raise OSError("pending failure")

    p.submit(boom)
    time.sleep(0.05)
    p.close()                        # no raise


def test_prefetcher_take_propagates_failure():
    p = _Prefetcher(retries=0)

    def boom():
        raise OSError("surfaced at take")

    p.submit(boom)
    with pytest.raises(OSError, match="surfaced"):
        p.take()
    p.close()


def test_prefetcher_retries_transient_failure():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return 7

    p = _Prefetcher(retries=2, backoff_s=0.0)
    p.submit(flaky)
    assert p.take() == 7 and calls["n"] == 3
    p.close()


def test_prefetcher_watchdog_times_out():
    p = _Prefetcher(deadline_s=0.05)
    p.submit(time.sleep, 5.0)
    with pytest.raises(PrefetchTimeout, match="watchdog"):
        p.take()
    p.close()


def test_watchdog_config_reaches_pipeline(corpora):
    e = LDAEngine(corpora[1], LDAConfig(**_kw(
        corpus_residency="streamed", stream_shards=4,
        stream_watchdog_seconds=30.0)), device="cpu")
    assert e.trainer.fused_pipeline()._prefetch.deadline_s == 30.0


def test_rebuild_closes_the_dead_attempts_prefetcher(corpora, tmp_path):
    """A supervised restart stops the old pipeline's worker before it
    builds the new trainer."""
    e = LDAEngine(corpora[1], LDAConfig(**_kw(corpus_residency="streamed",
                                                stream_shards=4)),
                  device="cpu", checkpoint_dir=str(tmp_path))
    e.fit(1)
    old = e.trainer.fused_pipeline()
    e._rebuild_trainer()
    assert old._prefetch._ex._shutdown
    assert e.trainer.fused_pipeline() is not old


def test_recovery_frees_the_dead_attempt(corpora, tmp_path):
    """After the rebuild nothing holds the dead attempt's trainer, its
    pipeline or its live state: not the engine, and not the frames of the
    fault's traceback (their locals and the closures they ran), which
    would keep the device memory a degrade needs."""
    import gc
    import weakref
    cfg = LDAConfig(**_kw(fused=True, eval_every=1, stream_shards=4))
    d = str(tmp_path)
    LDAEngine(corpora[1], cfg, device="cpu", checkpoint_dir=d).fit(
        2, supervise=SupervisePolicy(**_policy(checkpoint_every=2)))
    e = LDAEngine(corpora[1], cfg, device="cpu", checkpoint_dir=d)
    pipe, live = e.trainer.fused_pipeline(), {}

    def spy(run_fused):
        def call(fs, n, *a, **k):  # the allocator fails inside the chunk
            live["fs"] = weakref.ref(fs.D)
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 1.00 GiB")
        return call

    pipe.run_fused = spy(pipe.run_fused)
    dead = {"trainer": weakref.ref(e.trainer), "pipeline": weakref.ref(pipe)}
    del pipe
    rebuild, seen = e._rebuild_trainer, []

    def watch(report=None):
        rebuild(report)
        gc.collect()
        seen.append({k: r() is None for k, r in {**dead, **live}.items()})

    e._rebuild_trainer = watch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        h = e.fit(3, supervise=SupervisePolicy(**_policy(checkpoint_every=2)))
    rep = h["restart_report"]
    assert rep.degraded_to_streamed and rep.faults[0].startswith(
        "OutOfMemoryError: CUDA out of memory")
    assert _same(_port_ref(corpora[1], 5, fused=True, eval_every=1),
                 e.host_payload())
    assert seen == [{"trainer": True, "pipeline": True, "fs": True}]


def test_resolve_residency_warns_once_without_a_budget(monkeypatch):
    monkeypatch.setattr(lda_step, "_BUDGET_WARNED", False)
    cfg = LDAConfig(**_kw(corpus_residency="auto"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert lda_step.resolve_residency(cfg, 4096, "cpu") == ("full", 1)
        lda_step.resolve_residency(cfg, 4096, "cpu")
    hits = [w for w in rec if issubclass(w.category, RuntimeWarning)]
    assert len(hits) == 1 and "device_budget_bytes" in str(hits[0].message)


# -- the chaos harness itself ------------------------------------------------------

def test_chaos_hooks_noop_when_unarmed():
    chaos.clear()
    assert not chaos.armed() and chaos.plan() is None
    chaos.step_range(0, 100)
    chaos.shard_event(0, 0)
    chaos.io_fault(0)
    assert chaos.replica_event(0) is None
    assert not chaos.ps_owner_event(0, 0) and not chaos.ps_push_lost(0, 0)
    arrays = (np.arange(4),)
    assert chaos.corrupt_arrays(0, arrays) is arrays


def test_fault_plans_fire_like_the_reference():
    """Each hook, fed the same calls, fires the same faults in the same
    order in both packages: once by default, every time with repeat."""
    def events(ch, repeat):
        plan = ch.FaultPlan(
            raise_at_steps=(3,), oom_at_steps=(5,), raise_at_shards=((1, 2),),
            io_fault_shards=(4,), io_fault_attempts=2, corrupt_shards=(6,),
            corrupt_attempts=1, kill_replicas=(1,), ps_kill_owners=((0, 2),),
            ps_lose_pushes=((1, 3),), repeat=repeat)
        out = []
        with ch.active(plan):
            for call in (lambda: ch.step_range(0, 10),
                         lambda: ch.step_range(4, 3),
                         lambda: ch.shard_event(1, 2),
                         lambda: ch.io_fault(4),
                         lambda: ch.corrupt_arrays(6, (np.arange(3),))[0][0],
                         lambda: ch.replica_event(1),
                         lambda: ch.ps_owner_event(0, 2),
                         lambda: ch.ps_push_lost(1, 3)) * 3:
                try:
                    out.append(repr(call()))
                except Exception as e:     # noqa: BLE001 — compared below
                    out.append(f"{type(e).__name__}: {e}")
        assert not ch.armed()
        return out

    for repeat in (False, True):
        assert events(chaos, repeat) == events(jax_chaos, repeat)
