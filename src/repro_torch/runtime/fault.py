"""Fault tolerance + straggler instrumentation for long-running training.

Port of ``src/repro/runtime/fault.py``: the same policy, backoff, report
and restart loops. Two changes: ``is_oom_error`` also classifies PyTorch's
allocator failure (``torch.OutOfMemoryError``), so a real CUDA
out-of-memory fault takes the same degrade path as an injected one; and
the rank-agreed faults of the replicated multi-GPU trainer (``RankFault``,
``RankAbort``, ``fault_vote``), which the reference's single controller
does not need.

Rank-agreed faults. On ``torch.distributed`` every rank is its own
controller, and a rank that faults between two collectives would leave
the others blocked in the next one until the group times out. Under a
supervised fit (``LDAEngine.fit(supervise=)`` on the replicated backend)
every collective of ``runtime/sharding.py::ProcessMesh`` is preceded by a
vote: an all-reduce over the whole world of one small row a rank, zero
on a healthy rank. A rank that catches a fault enters the next vote with
its row filled (``fault_vote``: the fault's code and its exception's
name) in place of the collective it will never reach, and closes each
attempt with one more vote, so the vote it fills always meets the one
the healthy ranks make before their next collective (or after their
attempt). Every rank then raises the same ``RankFault`` (restartable,
naming each faulted rank and its fault), or ``RankAbort`` when a rank's
fault was not restartable. An out-of-memory fault votes a higher code
than any other restartable fault, so every rank takes the degrade branch
together. A fault inside a collective (an NCCL error, a lost peer) is not
one a vote can carry: it stays fatal, and the group's timeout ends it.

At thousand-node scale the failure model is: a pod/host dies mid-step, the
job scheduler restarts the process, and the run must resume from the newest
valid checkpoint — possibly on a *different* device count (elastic). The
pieces here are deliberately runtime-agnostic (no device APIs): the same logic
drives the CPU tests and a real launcher.

``SupervisePolicy`` is the knob surface a supervisor runs under: checkpoint
cadence (iterations, or mid-epoch shard groups for the streamed single-host
backend), a max-restart budget, bounded exponential backoff between
restarts, which exception types count as restartable, and the straggler
detector's window/threshold. ``supervised_loop`` is the generic
retry-with-recovery skeleton; ``run_with_restarts`` (the original
trainer-level supervision loop, contract unchanged) is now one instance of
it, and ``LDAEngine.fit(supervise=...)`` is the other.

``StepTimer`` is the straggler monitor: per-step wall-times with a robust
z-score flag. In the static-tile design intra-step stragglers cannot exist
(equal-token tiles), so stragglers surface *between* steps (a slow host,
failing HBM) — the signal a production babysitter acts on (demote the host,
shrink the data axis, restore elastically).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.runtime.chaos import SimulatedOOM

__all__ = ["FAULT_FATAL", "FAULT_OOM", "FAULT_RESTARTABLE", "RankAbort",
           "RankFault", "RestartReport", "StepTimer", "SupervisePolicy",
           "backoff_delay", "fault_vote", "is_oom_error", "run_with_restarts",
           "supervised_loop"]

# A rank's vote: its code, then its fault's exception name, one character
# a slot (zero-padded). A healthy rank votes a row of zeros.
FAULT_RESTARTABLE, FAULT_OOM, FAULT_FATAL = 1, 2, 3
VOTE_NAME_CHARS = 31
_FAULT_KIND = {FAULT_RESTARTABLE: "restartable",
               FAULT_OOM: "out-of-memory",
               FAULT_FATAL: "not restartable"}


class StepTimer:
    """Rolling per-step timing with robust straggler detection."""

    def __init__(self, window: int = 50, z_threshold: float = 4.0):
        self.window = window
        self.z = z_threshold
        self.times: list[float] = []

    def record(self, dt: float) -> bool:
        """Record one step; returns True if this step is a straggler."""
        self.times.append(dt)
        hist = np.asarray(self.times[-self.window:-1])
        if len(hist) < 8:
            return False
        med = np.median(hist)
        mad = np.median(np.abs(hist - med)) + 1e-12
        return (dt - med) / (1.4826 * mad) > self.z

    @property
    def summary(self) -> dict:
        t = np.asarray(self.times)
        return {"n": len(t), "median": float(np.median(t)) if len(t) else 0.0,
                "p99": float(np.percentile(t, 99)) if len(t) else 0.0}


@dataclasses.dataclass(frozen=True)
class SupervisePolicy:
    """How a supervised run checkpoints, restarts, and backs off.

    ``checkpoint_every`` is in iterations. ``checkpoint_shards`` (single-host
    streamed backend only) switches the cadence to mid-epoch: a checkpoint
    after every N stream shards, using the rewind-to-epoch-start
    ``stream_cursor`` payloads. ``restartable`` is the tuple of exception
    types the supervisor absorbs (anything else propagates immediately);
    it covers ``InvariantViolation``/``ShardCorruptionError`` (RuntimeError),
    prefetch I/O faults (OSError) and watchdog expiry (TimeoutError).
    ``sleep_fn`` exists so tests can supervise without wall-clock delays.
    """

    checkpoint_every: int = 1
    checkpoint_shards: int | None = None
    max_restarts: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_max: float = 5.0
    restartable: tuple = (RuntimeError, OSError, TimeoutError)
    straggler_window: int = 50
    straggler_z: float = 4.0
    sleep_fn: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.checkpoint_shards is not None and self.checkpoint_shards < 1:
            raise ValueError("checkpoint_shards must be >= 1 when set")
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.backoff_base < 0 or self.backoff_max < 0:
            raise ValueError("backoff must be >= 0")


def backoff_delay(policy: SupervisePolicy, restarts: int) -> float:
    """Bounded exponential backoff: base · factor^(restarts−1), capped."""
    if restarts <= 0:
        return 0.0
    return min(policy.backoff_max,
               policy.backoff_base * policy.backoff_factor ** (restarts - 1))


def is_oom_error(exc: BaseException) -> bool:
    """Classify device-memory exhaustion, real or injected.

    PyTorch's caching allocator raises ``torch.OutOfMemoryError`` ("CUDA
    out of memory. Tried to allocate ..."); a failed CUDA call reports
    "CUDA error: out of memory"; the reference's XLA failures and both
    packages' ``SimulatedOOM`` carry ``RESOURCE_EXHAUSTED``. A sticky
    CUDA fault (an illegal address, a launch failure) is not one of them:
    it leaves the context unusable, and ``max_restarts`` bounds its
    retries.
    """
    if isinstance(exc, (SimulatedOOM, torch.OutOfMemoryError)):
        return True
    msg = str(exc)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()


def fault_vote(exc: BaseException, restartable: tuple) -> np.ndarray:
    """This rank's vote row for ``exc``: FAULT_OOM for device-memory
    exhaustion, FAULT_RESTARTABLE for another fault of the policy's
    ``restartable`` types, FAULT_FATAL otherwise; then its exception's
    name."""
    if isinstance(exc, restartable):
        code = FAULT_OOM if is_oom_error(exc) else FAULT_RESTARTABLE
    else:
        code = FAULT_FATAL
    name = type(exc).__name__.encode("ascii", "replace")[:VOTE_NAME_CHARS]
    row = np.zeros(1 + VOTE_NAME_CHARS, np.int32)
    row[0] = code
    row[1:1 + len(name)] = np.frombuffer(name, np.uint8)
    return row


def _vote_text(votes: np.ndarray) -> str:
    parts = []
    for r in np.flatnonzero(votes[:, 0]):
        name = bytes(votes[r, 1:].astype(np.uint8)).rstrip(b"\0").decode()
        parts.append(f"rank {r}: {name} ({_FAULT_KIND[int(votes[r, 0])]})")
    return "; ".join(parts)


class RankFault(RuntimeError):
    """A restartable fault that the ranks of a process group agreed on.

    Raised on every rank with the same message, built from the vote alone
    (``votes``: one row a rank, code then exception name), so a supervised
    fit records the same fault on every rank. ``oom`` is set when any rank
    ran out of device memory: every rank then degrades together."""

    def __init__(self, votes: np.ndarray):
        self.votes = np.asarray(votes, np.int32)
        self.ranks = [int(r) for r in np.flatnonzero(self.votes[:, 0])]
        self.oom = bool((self.votes[:, 0] == FAULT_OOM).any())
        super().__init__(
            f"fault agreed by every rank: {_vote_text(self.votes)}"
            + (": out of memory" if self.oom else ""))


class RankAbort(Exception):
    """Another rank's fault was not restartable: every rank stops (not a
    ``RuntimeError``, so the supervisor does not retry it)."""

    def __init__(self, votes: np.ndarray):
        self.votes = np.asarray(votes, np.int32)
        super().__init__(
            f"aborted with the faulted ranks: {_vote_text(self.votes)}")


@dataclasses.dataclass
class RestartReport:
    """What supervision observed: restarts taken, where each attempt resumed
    from, per-fault messages, recovery wall-times, straggler step indices,
    and whether the run degraded from resident to streamed after an OOM."""

    completed_steps: int
    restarts: int
    resumed_from: list[int]
    faults: list[str] = dataclasses.field(default_factory=list)
    recovery_seconds: list[float] = dataclasses.field(default_factory=list)
    straggler_steps: list[int] = dataclasses.field(default_factory=list)
    elastic_reshards: list[tuple] = dataclasses.field(default_factory=list)
    degraded_to_streamed: bool = False
    timer_summary: dict = dataclasses.field(default_factory=dict)


def supervised_loop(run_attempt: Callable[[], Any],
                    recover: Callable[[BaseException], None],
                    policy: SupervisePolicy,
                    report: RestartReport) -> Any:
    """Generic restart skeleton: run, and on a restartable failure back off,
    recover, retry — up to ``policy.max_restarts`` times.

    ``run_attempt`` does one full attempt (restore-or-init through to the
    target step) and returns its result. ``recover(exc)`` rolls whatever
    state the caller owns back to restorable (rebuild a backend, drop a
    poisoned in-memory state). ``report`` is mutated in place: restarts,
    fault messages, and recovery wall-times.
    """
    while True:
        try:
            return run_attempt()
        except policy.restartable as e:
            report.restarts += 1
            report.faults.append(f"{type(e).__name__}: {e}")
            if report.restarts > policy.max_restarts:
                raise
            policy.sleep_fn(backoff_delay(policy, report.restarts))
            t0 = time.perf_counter()
            recover(e)
            report.recovery_seconds.append(time.perf_counter() - t0)


def run_with_restarts(make_trainer: Callable[[], Any],
                      n_steps: int,
                      manager,
                      checkpoint_every: int = 10,
                      max_restarts: int = 3,
                      fail_at: Callable[[int], bool] | None = None,
                      policy: SupervisePolicy | None = None
                      ) -> tuple[Any, RestartReport]:
    """Supervised training loop with checkpoint/restart.

    ``make_trainer`` builds a fresh trainer (possibly on a rescaled mesh —
    it is re-invoked after every failure). The trainer contract:
    ``init_state()``, ``step(state) -> (state, stats)``,
    ``host_payload(state) -> dict``, ``state_from_payload(dict) -> state``.

    ``fail_at(step)`` (tests/chaos) raising inside the loop simulates a node
    failure at that step boundary. Passing ``policy`` overrides the default
    (zero-backoff, RuntimeError-only) restart behavior; its
    ``checkpoint_every``/``max_restarts`` then take precedence over the
    positional arguments.
    """
    if policy is None:
        policy = SupervisePolicy(checkpoint_every=checkpoint_every,
                                 max_restarts=max_restarts,
                                 backoff_base=0.0,
                                 restartable=(RuntimeError,))
    report = RestartReport(0, 0, [])
    timer = StepTimer(policy.straggler_window, policy.straggler_z)

    def attempt():
        trainer = make_trainer()
        payload = manager.restore_latest()
        if payload is not None:
            state = trainer.state_from_payload(payload)
            report.resumed_from.append(int(payload["iteration"]))
        else:
            state = trainer.init_state()
        while int(state.iteration) < n_steps:
            step_idx = int(state.iteration)
            if fail_at is not None and fail_at(step_idx):
                raise RuntimeError(f"injected failure at step {step_idx}")
            t0 = time.perf_counter()
            state, _ = trainer.step(state)
            if timer.record(time.perf_counter() - t0):
                report.straggler_steps.append(step_idx)
            done = int(state.iteration)
            if done % policy.checkpoint_every == 0 or done == n_steps:
                manager.save(done, trainer.host_payload(state))
        return state

    state = supervised_loop(attempt, lambda e: None, policy, report)
    report.completed_steps = int(state.iteration)
    report.timer_summary = timer.summary
    return state, report
