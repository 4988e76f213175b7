"""The port's ``runtime/fault.py`` against the reference's.

The same inputs go to both packages: ``StepTimer`` flags the same steps on
the same seeded times, ``backoff_delay`` gives the same schedule,
``SupervisePolicy`` rejects the same knobs with the same errors,
``is_oom_error`` classifies both packages' ``SimulatedOOM``, PyTorch's own
``torch.OutOfMemoryError`` and the message strings, ``supervised_loop``
counts, backs off and propagates alike, and ``run_with_restarts`` on the
port's trainer restarts where the reference's does and ends bitwise the
port's uninterrupted run.
"""

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.lda.corpus import relabel_by_frequency, synthetic_lda_corpus
from repro.lda.model import LDAConfig as JaxConfig
from repro.lda.trainer import LDATrainer as JaxTrainer
from repro.runtime import chaos as jax_chaos
from repro.runtime import fault as jax_fault
from repro_torch.checkpoint import CheckpointManager
from repro_torch.lda import LDAConfig, LDATrainer
from repro_torch.runtime import chaos, fault
from _torch_parity import port_corpus

pytestmark = pytest.mark.chaos


# -- StepTimer ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window,z", [(50, 4.0), (16, 4.0), (10, 2.5)])
def test_step_timer_flags_the_same_steps(seed, window, z):
    rng = np.random.default_rng(seed)
    times = rng.lognormal(0.0, 0.1, size=60)
    times[rng.choice(60, size=4, replace=False)] *= rng.uniform(2, 8, 4)
    ref, port = jax_fault.StepTimer(window, z), fault.StepTimer(window, z)
    want = [ref.record(float(t)) for t in times]
    got = [port.record(float(t)) for t in times]
    assert got == want and any(got)
    assert port.summary == ref.summary


def test_step_timer_empty_summary():
    assert fault.StepTimer().summary == jax_fault.StepTimer().summary


# -- backoff and the policy ---------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(backoff_base=0.1, backoff_factor=2.0, backoff_max=0.5),
    dict(backoff_base=0.0), dict(backoff_base=1.0, backoff_factor=3.0,
                                 backoff_max=100.0)])
def test_backoff_schedule_matches_the_reference(kw):
    ref, port = jax_fault.SupervisePolicy(**kw), fault.SupervisePolicy(**kw)
    for r in range(8):
        assert fault.backoff_delay(port, r) == jax_fault.backoff_delay(ref, r)
    # the reference's own schedule test
    pol = fault.SupervisePolicy(backoff_base=0.1, backoff_factor=2.0,
                                backoff_max=0.5)
    assert [fault.backoff_delay(pol, r) for r in (0, 1, 2, 3, 5)] == \
        pytest.approx([0.0, 0.1, 0.2, 0.4, 0.5])


@pytest.mark.parametrize("bad", [
    dict(checkpoint_every=0), dict(checkpoint_shards=0),
    dict(max_restarts=-1), dict(backoff_base=-1.0), dict(backoff_max=-1.0)])
def test_policy_validation_matches_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jax_fault.SupervisePolicy(**bad)
    with pytest.raises(ValueError) as got:
        fault.SupervisePolicy(**bad)
    assert str(got.value) == str(want.value)


def test_policy_defaults_match_the_reference():
    ref, port = jax_fault.SupervisePolicy(), fault.SupervisePolicy()
    for f in ("checkpoint_every", "checkpoint_shards", "max_restarts",
              "backoff_base", "backoff_factor", "backoff_max",
              "straggler_window", "straggler_z"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.restartable == ref.restartable


# -- the out-of-memory classifier ---------------------------------------------

@pytest.mark.parametrize("exc,oom", [
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory while trying to "
                  "allocate"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (ValueError("shape mismatch"), False),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (OSError("chaos: injected prefetch I/O error (shard 0)"), False)])
def test_is_oom_error_classifies_messages_like_the_reference(exc, oom):
    assert jax_fault.is_oom_error(exc) is oom
    assert fault.is_oom_error(exc) is oom


def test_is_oom_error_classifies_both_simulated_ooms_and_torch_oom():
    for sim in (chaos.SimulatedOOM("unit"), jax_chaos.SimulatedOOM("unit")):
        assert fault.is_oom_error(sim) and jax_fault.is_oom_error(sim)
        assert "RESOURCE_EXHAUSTED" in str(sim)
    # PyTorch's allocator failure, by type whatever its message says
    assert fault.is_oom_error(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert fault.is_oom_error(torch.OutOfMemoryError("allocator refused"))
    assert not jax_fault.is_oom_error(
        torch.OutOfMemoryError("allocator refused"))


# -- supervised_loop ------------------------------------------------------------

def _loop(mod, failures, **kw):
    """``supervised_loop`` over an attempt that fails ``failures`` times;
    returns (result or exception type name, report, sleeps, recoveries)."""
    sleeps, recovered = [], []
    state = {"n": 0}

    def attempt():
        state["n"] += 1
        if state["n"] <= len(failures):
            raise failures[state["n"] - 1]
        return state["n"]

    pol = mod.SupervisePolicy(sleep_fn=sleeps.append, **kw)
    rep = mod.RestartReport(0, 0, [])
    try:
        out = mod.supervised_loop(attempt, lambda e: recovered.append(
            type(e).__name__), pol, rep)
    except BaseException as e:     # noqa: BLE001 — compared across packages
        out = type(e).__name__
    return out, rep.restarts, rep.faults, sleeps, recovered, \
        len(rep.recovery_seconds)


@pytest.mark.parametrize("failures,kw", [
    ([], {}),
    ([RuntimeError("a"), OSError("b")], dict(backoff_base=0.5)),
    ([TimeoutError("w")] * 3, dict(max_restarts=2)),
    ([RuntimeError("x")] * 5, dict(max_restarts=4, backoff_max=0.3)),
    ([KeyError("not restartable")], {})])
def test_supervised_loop_matches_the_reference(failures, kw):
    assert _loop(fault, failures, **kw) == _loop(jax_fault, failures, **kw)


# -- run_with_restarts on the port's trainer ------------------------------------

def test_run_with_restarts_resumes_like_the_reference(tmp_path):
    """The reference's test_run_with_restarts_resumes on both trainers:
    failures at steps 7 and 13, checkpoints every 5, two restarts resumed
    from 5 and 10; the port ends bitwise its uninterrupted run."""
    c = synthetic_lda_corpus(3, n_docs=40, n_words=60, n_topics=6,
                             mean_doc_len=30)
    c, _ = relabel_by_frequency(c)
    pc = port_corpus(c)
    kw = dict(n_topics=8, tile_size=256, seed=11)

    def fail_once(failures):
        seen = set()

        def fail_at(step):
            if step in failures and step not in seen:
                seen.add(step)
                return True
            return False
        return fail_at

    _, want = jax_fault.run_with_restarts(
        lambda: JaxTrainer(c, JaxConfig(**kw), _from_engine=True),
        n_steps=20, manager=JaxManager(str(tmp_path / "ref"), keep_n=3),
        checkpoint_every=5, fail_at=fail_once({7, 13}))
    state, got = fault.run_with_restarts(
        lambda: LDATrainer(pc, LDAConfig(**kw), device="cpu"), n_steps=20,
        manager=CheckpointManager(str(tmp_path / "port"), keep_n=3),
        checkpoint_every=5, fail_at=fail_once({7, 13}))
    for f in ("completed_steps", "restarts", "resumed_from",
              "degraded_to_streamed"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.resumed_from == [5, 10] and got.completed_steps == 20
    assert got.timer_summary["n"] == want.timer_summary["n"]

    tr = LDATrainer(pc, LDAConfig(**kw), device="cpu")
    ref = tr.init_state()
    for _ in range(20):
        ref, _ = tr.step(ref)
    assert torch.equal(ref.topics, state.topics)
    assert torch.equal(ref.D, state.D) and torch.equal(ref.W, state.W)
