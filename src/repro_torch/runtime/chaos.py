"""Deterministic fault injection: the chaos harness behind the recovery tests.

Port of ``src/repro/runtime/chaos.py``, whole (it is pure Python): the same
plan, hooks and firing rules, so one ``FaultPlan`` fires at the same
places in both packages.

Fault tolerance that is never exercised is a rumor. This module gives every
recovery path in the stack a deterministic, CPU-testable trigger: a
``FaultPlan`` names *where* faults fire (step indices, epoch shards,
prefetch attempts) and the training loops carry opt-in hooks —
``armed()`` is a single module-global check, so an un-armed run pays one
``is None`` per hook site and never syncs, sleeps, or raises.

Hook sites (all behind ``armed()``):

  * ``step_range(start, n)`` — iteration-boundary faults, called by the
    boundary-chunked loops before each scanned chunk (and by the
    stepwise oracle loop per iteration): raise-at-step, simulated OOM,
    slow-step stragglers.
  * ``shard_event(iteration, shard)`` — mid-epoch faults inside the
    streaming epoch loop (``StreamingPipeline._advance``): kills a run
    with an epoch open.
  * ``io_fault(shard)`` / ``corrupt_arrays(shard, arrays)`` — inside the
    shard load (``StreamingPipeline._put_shard``, on the prefetch worker
    thread for every shard but an epoch's first): the in-memory slice path
    and the disk-native file layer
    (``repro_torch.lda.storage.CorpusStore.read_shard`` with ``_chaos=True``,
    between the ``np.load`` and the crc32 verify). Injected I/O errors
    exercise the prefetcher's retry/backoff; injected bit flips exercise
    the shard crc32 self-check (``ShardCorruptionError`` on disk reads).
  * ``ps_owner_event(owner, clock)`` / ``ps_push_lost(worker, clock)`` —
    the parameter-server drills (the reference's ``repro.lda.ps``; the
    port's parameter server arrives with ROADMAP.md Queue 1 #12): a planned owner kill
    wipes one W shard's committed rows (recovery = snapshot restore +
    client journal replay), a planned lost push drops one delta block on
    the wire (recovery = un-acked resend from the client's push journal).
    ``ps_slow_workers`` is read by the PS scheduler via ``plan()`` as a
    standing clock bias, forcing stale-but-admissible pulls.
  * ``replica_event(rid)`` — the serving tier's worker loop (the
    reference's ``repro.serve.service``; the port's serving tier arrives
    with ROADMAP.md Queue 1 #13) polls it once per picked-up batch:
    ``kill_replicas`` makes the worker die holding a batch (exercising
    the re-queue + surviving-replica path), ``slow_replicas`` injects a
    one-shot straggler sleep (exercising work-stealing re-routing).

Faults fire ONCE per plan by default (``repeat=False``): after the
supervisor restarts from a checkpoint the same plan stays installed but
the fault does not re-fire, so every chaos test converges
deterministically. Attempt-counted faults (``io_fault_attempts`` /
``corrupt_attempts``) fire for the first N *load attempts* of a shard —
set N at or below the prefetcher's retry budget to exercise in-place
retry, above it to force a supervised restart.

``SimulatedOOM`` deliberately prints as ``RESOURCE_EXHAUSTED`` so the
engine's OOM classifier (``repro_torch.runtime.fault.is_oom_error``)
treats real and injected device exhaustion identically; the classifier
also takes PyTorch's own ``torch.OutOfMemoryError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Mapping

__all__ = ["FaultPlan", "InjectedFault", "SimulatedOOM", "active", "armed",
           "clear", "corrupt_arrays", "install", "io_fault", "plan",
           "ps_owner_event", "ps_push_lost", "replica_event", "shard_event",
           "step_range"]


class InjectedFault(RuntimeError):
    """Default exception for raise-at-step faults (a 'node died')."""


class SimulatedOOM(RuntimeError):
    """Injected device-memory exhaustion.

    The message carries ``RESOURCE_EXHAUSTED`` — the substring the
    reference's XLA allocator failures carry — so one classifier handles
    injected and real exhaustion in both packages.
    """

    def __init__(self, where: str = "chaos"):
        super().__init__(
            f"RESOURCE_EXHAUSTED: simulated out-of-memory ({where})")


@dataclasses.dataclass
class FaultPlan:
    """Where and how faults fire. Indices are absolute training steps
    (iterations) or epoch-shard indices; see the module docstring for
    which hook consumes which field."""

    raise_at_steps: tuple = ()         # InjectedFault at a step boundary
    raise_at_shards: tuple = ()        # (iteration, shard) mid-epoch kills
    oom_at_steps: tuple = ()           # SimulatedOOM at a step boundary
    io_fault_shards: tuple = ()        # OSError from the shard slice load
    io_fault_attempts: int = 1         # consecutive failing load attempts
    corrupt_shards: tuple = ()         # flip one bit in the shard's bytes
    corrupt_attempts: int = 1          # consecutive corrupted load attempts
    slow_steps: Mapping[int, float] = \
        dataclasses.field(default_factory=dict)   # step -> extra seconds
    kill_replicas: tuple = ()          # serving replica ids to kill
    slow_replicas: Mapping[int, float] = \
        dataclasses.field(default_factory=dict)   # rid -> extra seconds
    ps_kill_owners: tuple = ()         # (owner, clock): wipe a W owner shard
    ps_lose_pushes: tuple = ()         # (worker, clock): drop one delta push
    ps_slow_workers: Mapping[int, int] = \
        dataclasses.field(default_factory=dict)   # worker -> clock bias
    repeat: bool = False               # re-fire after a restart?
    exc_factory: Callable[[str], Exception] = InjectedFault

    def __post_init__(self):
        self._fired: set = set()
        self._attempts: dict = {}

    def _should_fire(self, key) -> bool:
        if self.repeat:
            return True
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    def _attempt_count(self, key) -> int:
        n = self._attempts.get(key, 0) + 1
        self._attempts[key] = n
        return n


_PLAN: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def armed() -> bool:
    """True iff a FaultPlan is installed (the hooks' fast-path guard)."""
    return _PLAN is not None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """``with chaos.active(FaultPlan(...)):`` — install for one block."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


# -- hooks (each is a no-op when no plan is installed) -----------------------

def step_range(start: int, n: int) -> None:
    """Fire any step-indexed fault whose step falls in [start, start+n).

    Called at chunk granularity: a scanned stretch of ``n`` iterations is
    one dispatch, so a fault 'at step k' fires at the chunk boundary that
    covers k — exactly where a real mid-chunk death would be observed
    from (the in-flight device state is lost either way).
    """
    plan = _PLAN
    if plan is None:
        return
    for step in range(int(start), int(start) + int(n)):
        extra = plan.slow_steps.get(step)
        if extra is not None and plan._should_fire(("slow", step)):
            time.sleep(float(extra))
        if step in plan.oom_at_steps and plan._should_fire(("oom", step)):
            raise SimulatedOOM(f"step {step}")
        if step in plan.raise_at_steps \
                and plan._should_fire(("raise", step)):
            raise plan.exc_factory(
                f"chaos: injected failure at step {step}")


def shard_event(iteration: int, shard: int) -> None:
    """Fire a mid-epoch kill planned for (iteration, shard)."""
    plan = _PLAN
    if plan is None:
        return
    key = (int(iteration), int(shard))
    if key in plan.raise_at_shards \
            and plan._should_fire(("raise_shard", key)):
        raise plan.exc_factory(
            f"chaos: injected failure at iteration {key[0]}, "
            f"shard {key[1]} (mid-epoch)")


def replica_event(rid: int) -> str | None:
    """Serving-replica fault poll, once per picked-up micro-batch.

    A planned straggler (``slow_replicas[rid]`` seconds) sleeps HERE —
    on the replica's worker thread, holding its batch — and returns
    None; a planned kill returns ``"kill"`` and lets the caller die
    holding the batch (the service re-queues it). Both fire once per
    plan unless ``repeat``.
    """
    plan = _PLAN
    if plan is None:
        return None
    r = int(rid)
    extra = plan.slow_replicas.get(r)
    if extra is not None and plan._should_fire(("slow_replica", r)):
        time.sleep(float(extra))
    if r in plan.kill_replicas \
            and plan._should_fire(("kill_replica", r)):
        return "kill"
    return None


def plan() -> FaultPlan | None:
    """The installed plan, if any — for hooks that need to *read* plan
    fields rather than fire a fault (the PS scheduler's ``ps_slow_workers``
    clock bias is a standing schedule perturbation, not a one-shot)."""
    return _PLAN


def ps_owner_event(owner: int, clock: int) -> bool:
    """True once per plan if W owner ``owner`` should die at ``clock``.

    The parameter server polls this before serving a round commit; a True
    return wipes that owner's committed rows, forcing the caller through
    the snapshot-restore + journal-replay recovery path
    (the reference's ``repro.lda.ps.ParameterServer.revive_owner``).
    """
    p = _PLAN
    if p is None:
        return False
    key = (int(owner), int(clock))
    return key in p.ps_kill_owners and p._should_fire(("ps_kill", key))


def ps_push_lost(worker: int, clock: int) -> bool:
    """True once per plan if worker ``worker``'s next delta push at round
    ``clock`` should be dropped on the wire (server never applies it; the
    client sees no ack and must resend from its push journal)."""
    p = _PLAN
    if p is None:
        return False
    key = (int(worker), int(clock))
    return key in p.ps_lose_pushes and p._should_fire(("ps_lose", key))


def io_fault(shard: int) -> None:
    """Raise OSError for the first ``io_fault_attempts`` loads of a shard."""
    plan = _PLAN
    if plan is None:
        return
    s = int(shard)
    if s in plan.io_fault_shards \
            and plan._attempt_count(("io", s)) <= plan.io_fault_attempts:
        raise OSError(f"chaos: injected prefetch I/O error (shard {s})")


def corrupt_arrays(shard: int, arrays: tuple) -> tuple:
    """Flip one bit in a COPY of the shard's first array for the first
    ``corrupt_attempts`` loads — the backing store stays clean, so a
    retry or a supervised restart reloads good bytes."""
    plan = _PLAN
    if plan is None:
        return arrays
    s = int(shard)
    if s in plan.corrupt_shards \
            and plan._attempt_count(("corrupt", s)) \
            <= plan.corrupt_attempts:
        first = arrays[0].copy()
        first.flat[0] ^= 1
        return (first,) + tuple(arrays[1:])
    return arrays
