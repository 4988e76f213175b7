"""The always-on fold-in front: micro-batching, backpressure, refresh.

Port of ``src/repro/serve/service.py``: the same ``ServeConfig`` and its
validation, the same queues, threads, backpressure, work stealing,
re-queue on a dead replica and graceful drain. The sampling key is an
integer seed: a batch draws from ``uniforms_generator(seed, seq)``
(``serve/replicas.py``), and ``submit_batch(docs, key=s)`` pins seed ``s``
with seq 0, as the reference pins a key.

``LDAService`` turns ``FrozenLDAModel``'s batch fold-in into a service:

  * **micro-batching** — single-doc ``infer()``/``submit()`` calls land in
    a bounded pending queue; one batcher thread coalesces them under a
    deadline/size policy (cut when ``max_batch`` docs are waiting OR
    ``max_delay_ms`` has elapsed since the batcher started filling this
    batch), so tail latency is bounded by the deadline while throughput
    rides the pow2 batch buckets;
  * **backpressure** — a full pending queue rejects with
    ``ServiceOverloaded`` instead of buffering unboundedly (the caller
    retries or sheds load; latency stays honest);
  * **replicated dispatch** — cut batches go into ONE shared dispatch
    queue that N replica workers pull from (work stealing: a slow or dead
    replica's share is simply picked up by the others — that, not any
    explicit re-routing logic, is how the straggler/kill chaos tests
    pass); a worker that the chaos harness kills re-queues the batch it
    picked up, so every accepted request is still answered as long as one
    replica survives;
  * **bounded-staleness refresh** — ``refresh(snapshot)`` builds each
    replica's new tables off the serving path and pointer-swaps them
    (``serve/cache.py``); in-flight batches finish on the tables they
    captured. Out-of-order snapshots (stale ``seq``) are dropped;
  * **graceful drain** — ``close()`` stops intake, flushes the pending
    queue through the batcher, and joins the workers; every accepted
    future resolves.

Determinism: batch ``seq`` drives the sampling stream (``(seed, seq)``),
so a fixed batch composition is bit-reproducible on a device;
``submit_batch(docs, key=...)`` pins the seed explicitly, the handle the
bitwise refresh-equivalence tests use.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.lda.model import head_rows_for_coverage
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.replicas import ReplicaSet, pack_docs

__all__ = ["LDAService", "ServeConfig", "ServiceClosed",
           "ServiceOverloaded"]


class ServiceOverloaded(RuntimeError):
    """Pending queue full: backpressure — retry later or shed load."""


class ServiceClosed(RuntimeError):
    """The service is closed (or closing) and takes no new requests."""


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Micro-batching / replication / cache policy for ``LDAService``.

    ``buckets`` are the pow2 doc-count buckets a cut batch is padded to
    (ascending; the largest is the effective ``max_batch`` cap);
    ``max_delay_ms`` bounds how long a filling batch waits for
    co-riders, measured from the moment the batcher picks up its first
    doc (NOT from submit time: an already-expired submit-time deadline
    would cut odd-sized batches). ``n_sweeps=2`` with ``warm_start=True``
    is the reference's measured serving setting. ``hot_words=None`` pins
    the full vocabulary (every token a hit) unless ``hot_coverage`` is
    set, in which case the service sizes the pinned head from the model's
    own word-mass curve (``repro_torch.lda.model.head_rows_for_coverage``):
    the smallest head holding that fraction of training tokens, the
    expected hit rate on traffic that matches the training distribution.
    """
    max_batch: int = 256
    max_delay_ms: float = 2.0
    buckets: tuple = (8, 16, 32, 64, 128, 256)
    queue_limit: int = 4096
    n_replicas: int = 1
    n_sweeps: int = 2
    warm_start: bool = True
    hot_words: int | None = None
    hot_coverage: float | None = None
    token_floor: int = 256
    seed: int = 0

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(self.buckets):
            raise ValueError("buckets must be a non-empty ascending tuple")
        bad = [b for b in self.buckets if not _is_pow2(int(b))]
        if bad:
            raise ValueError(f"buckets must be powers of two, got {bad}")
        if self.max_batch > max(self.buckets):
            raise ValueError(
                f"max_batch={self.max_batch} exceeds the largest bucket "
                f"{max(self.buckets)}: a cut batch could never be padded")
        if self.max_batch < 1 or self.queue_limit < 1:
            raise ValueError("max_batch and queue_limit must be >= 1")
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if self.n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1")
        if self.hot_coverage is not None \
                and not 0.0 < self.hot_coverage <= 1.0:
            raise ValueError(
                f"hot_coverage={self.hot_coverage} must be in (0, 1]")
        if self.hot_words is not None and self.hot_coverage is not None:
            raise ValueError("pass hot_words OR hot_coverage, not both")


@dataclasses.dataclass
class _Request:
    doc: np.ndarray
    future: concurrent.futures.Future
    t0: float


@dataclasses.dataclass
class _MicroBatch:
    requests: list
    seq: int
    queue_depth: int
    key: int | None = None      # explicit seed (submit_batch) or None


_SHUTDOWN = object()


class LDAService:
    """Always-on serving front over a frozen (but refreshable) LDA model.

    >>> service = LDAService(engine.export(), ServeConfig(n_replicas=2))
    >>> theta = service.infer(doc)               # blocking single doc
    >>> fut = service.submit(doc)                # async single doc
    >>> service.refresh(snapshot)                # bounded-staleness swap
    >>> service.close()                          # drain + join
    """

    def __init__(self, model, config: ServeConfig | None = None, *,
                 mesh=None, metrics: ServeMetrics | None = None):
        self.config = cfg = config or ServeConfig()
        self.model_meta = {"n_words": model.n_words,
                           "n_topics": model.n_topics,
                           "alpha": float(model.alpha),
                           "beta": float(model.beta), "g": model.g}
        hot_words = cfg.hot_words
        if hot_words is None and cfg.hot_coverage is not None:
            hot_words = head_rows_for_coverage(
                np.asarray(model.W).sum(axis=1), cfg.hot_coverage)
        self.hot_words = hot_words
        self.replicas = ReplicaSet(model, n_replicas=cfg.n_replicas,
                                   mesh=mesh, hot_words=hot_words,
                                   warm_start=cfg.warm_start)
        self.metrics = metrics or ServeMetrics()
        self._n_words = model.n_words
        self._word_map = model.word_map
        self._seed = int(cfg.seed)
        # pending is a plain deque + edge-triggered Event, NOT a
        # queue.Queue: append/popleft are GIL-atomic (~100 ns), while a
        # Queue pays a lock acquire + condition notify on EVERY put —
        # per-request overhead that becomes the service's throughput
        # ceiling on a busy intake thread
        self._pending: collections.deque = collections.deque()
        self._pending_has = threading.Event()
        self._dispatch: collections.deque = collections.deque()
        self._dispatch_cv = threading.Condition()
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._snapshot_seq = -1
        self._refresh_lock = threading.Lock()
        self._closed = False
        self._batcher = threading.Thread(target=self._batcher_loop,
                                         name="lda-serve-batcher",
                                         daemon=True)
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(r,),
                             name=f"lda-serve-replica-{r.rid}",
                             daemon=True)
            for r in self.replicas.replicas]
        self._batcher.start()
        for w in self._workers:
            w.start()

    # -- request intake -------------------------------------------------------

    def submit(self, doc: Sequence[int]) -> concurrent.futures.Future:
        """Enqueue one document; resolves to its (K,) θ row."""
        if self._closed:
            raise ServiceClosed("service is closed")
        if len(self._pending) >= self.config.queue_limit:
            self.metrics.record_rejected()
            raise ServiceOverloaded(
                f"pending queue at its limit ({self.config.queue_limit} "
                "requests): the service is saturated — retry with "
                "backoff, add replicas, or raise queue_limit")
        fut = concurrent.futures.Future()
        req = _Request(doc=np.asarray(doc, np.int64).ravel(), future=fut,
                       t0=time.perf_counter())
        self._pending.append(req)
        if not self._pending_has.is_set():
            self._pending_has.set()
        return fut

    def infer(self, doc: Sequence[int],
              timeout: float | None = None) -> np.ndarray:
        """Blocking single-doc θ (the convenience wrapper over submit)."""
        return self.submit(doc).result(timeout=timeout)

    def submit_batch(self, docs: Sequence[Sequence[int]],
                     key=None) -> list:
        """Enqueue docs as ONE micro-batch (bypasses coalescing but not
        the dispatch queue/workers). An explicit integer ``key`` pins the
        sampling seed (with seq 0): the deterministic path the
        refresh-equivalence tests drive."""
        if self._closed:
            raise ServiceClosed("service is closed")
        now = time.perf_counter()
        reqs = [_Request(doc=np.asarray(d, np.int64).ravel(),
                         future=concurrent.futures.Future(), t0=now)
                for d in docs]
        self._enqueue_batch(_MicroBatch(
            requests=reqs, seq=self._next_seq(),
            queue_depth=len(self._pending), key=key))
        return [r.future for r in reqs]

    def transform(self, docs: Sequence[Sequence[int]], key=None,
                  timeout: float | None = None) -> np.ndarray:
        """Synchronous batch θ through the full service path."""
        futs = self.submit_batch(docs, key=key)
        return np.stack([f.result(timeout=timeout) for f in futs])

    def warmup(self) -> int:
        """Run one synthetic batch through EVERY replica, its tail path
        included, off the serving path: the kernels are built (``nvcc``)
        and the allocator warmed before the first request. The reference
        compiles its jit signature lattice here; the port runs eagerly
        and has no signatures to compile. Returns the replicas warmed;
        the hit-rate counters are left as they were."""
        cfg = self.config
        # originals that land on internal ids 0 (always hot) and V-1 (in
        # the tail whenever there is one)
        if self._word_map is not None:
            wm = np.asarray(self._word_map)
            head_w = int(np.argmax(wm == 0))
            tail_w = int(np.argmax(wm == self._n_words - 1))
        else:
            head_w, tail_w = 0, self._n_words - 1
        packed = pack_docs([[head_w, tail_w]] * min(cfg.buckets),
                           n_words=self._n_words, word_map=self._word_map,
                           doc_buckets=cfg.buckets,
                           token_floor=cfg.token_floor)
        for r in self.replicas.replicas:
            h, m = r.cache.hits, r.cache.misses
            r.infer_packed(packed, 0, n_sweeps=cfg.n_sweeps, with_llpt=False)
            r.cache.hits, r.cache.misses = h, m
        return len(self.replicas)

    # -- refresh (bounded-staleness swap) ------------------------------------

    def refresh(self, snapshot) -> bool:
        """Swap every replica to ``snapshot`` (a ``ServingSnapshot``).

        Returns False (and changes nothing) for an out-of-order snapshot;
        raises for one that is structurally incompatible with the model
        this service was built from.
        """
        W = np.asarray(snapshot.W, np.int32)
        meta = self.model_meta
        if W.shape != (meta["n_words"], meta["n_topics"]):
            raise ValueError(
                f"snapshot W has shape {W.shape}, the service serves "
                f"({meta['n_words']}, {meta['n_topics']}): refresh must "
                "come from the same model family")
        for field, want in (("alpha", meta["alpha"]),
                            ("beta", meta["beta"]), ("g", meta["g"])):
            if getattr(snapshot, field, want) != want:
                raise ValueError(
                    f"snapshot {field}={getattr(snapshot, field)} != "
                    f"serving {field}={want}: hyperparameters are frozen "
                    "at service construction")
        with self._refresh_lock:
            if snapshot.seq <= self._snapshot_seq:
                return False            # stale publish: never roll back
            self.replicas.swap(W)
            self._snapshot_seq = snapshot.seq
        self.metrics.record_refresh(snapshot.staleness_steps,
                                    snapshot.seq)
        return True

    # -- lifecycle ------------------------------------------------------------

    def close(self, drain: bool = True,
              timeout: float | None = 30.0) -> None:
        """Stop intake, flush (or fail) queued work, join the threads."""
        if self._closed:
            return
        self._closed = True
        if not drain:
            self._fail_pending(ServiceClosed("service closed undrained"))
        self._batcher.join(timeout=timeout)
        with self._dispatch_cv:
            for _ in self._workers:
                self._dispatch.append(_SHUTDOWN)
            self._dispatch_cv.notify_all()
        for w in self._workers:
            w.join(timeout=timeout)
        # anything still queued (e.g. every replica dead) must not hang
        # its caller forever
        self._fail_dispatched(ServiceClosed(
            "service closed with no replica able to answer"))

    def __enter__(self) -> "LDAService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals ------------------------------------------------------------

    def _next_seq(self) -> int:
        with self._seq_lock:
            s = self._seq
            self._seq += 1
            return s

    def _enqueue_batch(self, mb: _MicroBatch) -> None:
        with self._dispatch_cv:
            self._dispatch.append(mb)
            self._dispatch_cv.notify()

    def _fail_pending(self, exc: Exception) -> None:
        while True:
            try:
                req = self._pending.popleft()
            except IndexError:
                return
            req.future.set_exception(exc)
            self.metrics.record_failed()

    def _fail_dispatched(self, exc: Exception) -> None:
        with self._dispatch_cv:
            batches = [b for b in self._dispatch if b is not _SHUTDOWN]
            self._dispatch.clear()
        for mb in batches:
            for req in mb.requests:
                if not req.future.done():
                    req.future.set_exception(exc)
                    self.metrics.record_failed()

    def _batcher_loop(self) -> None:
        cfg = self.config
        delay_s = cfg.max_delay_ms / 1e3
        bound = max(2 * len(self._workers), 2)
        while True:
            # real backpressure: while the dispatch backlog is already
            # ``bound`` batches deep, stop draining the bounded pending
            # queue — it fills to queue_limit and submit() sheds load,
            # instead of the deque hoarding unbounded accepted work
            with self._dispatch_cv:
                while len([b for b in self._dispatch
                           if b is not _SHUTDOWN]) >= bound \
                        and not self._closed:
                    self._dispatch_cv.wait(timeout=0.02)
            try:
                first = self._pending.popleft()
            except IndexError:
                if self._closed:
                    return
                # edge-triggered wait: submit() sets the event only on
                # the empty->non-empty transition, so an idle service
                # sleeps here without per-request lock traffic
                self._pending_has.clear()
                if not self._pending:
                    self._pending_has.wait(timeout=0.02)
                continue
            batch = [first]
            # deadline counts from when the batcher picked the batch up,
            # NOT from the oldest request's submit time: under a burst
            # the consumer can momentarily outrun the producer, and a
            # long-expired submit-time deadline would cut an odd-sized
            # batch (fresh jit signature -> a compile on the serving
            # path) when waiting a hair longer yields a full bucket
            deadline = time.perf_counter() + delay_s
            while len(batch) < cfg.max_batch:
                # drain what is ALREADY waiting without consulting the
                # deadline — under burst the oldest request's deadline
                # has long passed, but cutting early would ship a
                # near-empty batch while the queue holds a full one
                try:
                    batch.append(self._pending.popleft())
                    continue
                except IndexError:
                    pass
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._pending_has.clear()
                if not self._pending:
                    self._pending_has.wait(timeout=remaining)
            self._enqueue_batch(_MicroBatch(
                requests=batch, seq=self._next_seq(),
                queue_depth=len(self._pending)))

    def _take_batch(self):
        with self._dispatch_cv:
            while not self._dispatch:
                self._dispatch_cv.wait(timeout=0.1)
            mb = self._dispatch.popleft()
            self._dispatch_cv.notify_all()     # wake the bounded batcher
            return mb

    def _worker_loop(self, replica) -> None:
        cfg = self.config
        while True:
            mb = self._take_batch()
            if mb is _SHUTDOWN:
                return
            event = self.replicas.chaos_event(replica.rid)
            if event == "kill":
                # the replica dies holding a batch: re-queue it at the
                # FRONT so a surviving replica answers those requests
                # first — no accepted request is lost with a survivor up
                replica.kill()
                self.metrics.record_requeued_batch()
                with self._dispatch_cv:
                    self._dispatch.appendleft(mb)
                    self._dispatch_cv.notify()
                if not self.replicas.alive:
                    self._fail_dispatched(RuntimeError(
                        "every serving replica is dead"))
                return
            # explicit seeds (submit_batch) pin seq=0, so a fixed seed is
            # reproducible across calls
            key, seq = (mb.key, 0) if mb.key is not None \
                else (self._seed, mb.seq)
            try:
                packed = pack_docs(
                    [r.doc for r in mb.requests], n_words=self._n_words,
                    word_map=self._word_map, doc_buckets=cfg.buckets,
                    token_floor=cfg.token_floor)
                theta, _llpt, info = replica.infer_packed(
                    packed, key, n_sweeps=cfg.n_sweeps, seq=seq,
                    with_llpt=False)
            except Exception as exc:     # noqa: BLE001 — futures carry it
                for req in mb.requests:
                    req.future.set_exception(exc)
                self.metrics.record_failed(len(mb.requests))
                continue
            done = time.perf_counter()
            for row, req in zip(theta, mb.requests):
                req.future.set_result(row)
            self.metrics.record_requests(
                [done - req.t0 for req in mb.requests])
            self.metrics.record_batch(len(mb.requests), packed.n_docs,
                                      mb.queue_depth)
            self.metrics.record_cache(info["cache_hits"],
                                      info["cache_misses"])

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        """Plain-dict observability snapshot (metrics + replica state)."""
        snap = self.metrics.snapshot()
        snap["alive_replicas"] = len(self.replicas.alive)
        snap["n_replicas"] = len(self.replicas)
        snap["dispatch_depth"] = len(self._dispatch)
        return snap
