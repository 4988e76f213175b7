"""Serving observability: latency histograms, queue/batch/cache counters.

Port of ``src/repro/serve/metrics.py``, whole (it is plain Python; the
port keeps its own copy): the same buckets, percentiles and snapshot, so
the two packages report the same numbers for the same samples.

One ``ServeMetrics`` instance rides inside an ``LDAService``; every hook is
O(1) under one lock (the service's hot path records a handful of floats per
BATCH, not per request, except the per-request latency sample). ``snapshot()``
exports a plain dict — the only consumer contract — so the tests, the card
run and any external scraper read the same numbers.

Latency percentiles come from a fixed log-spaced bucket histogram
(``LatencyHistogram``): 10 µs .. ~100 s at 5% resolution, constant memory,
deterministic. A percentile is resolved to the upper edge of the bucket the
cumulative count crosses — the conservative (never-understated) convention.
"""

from __future__ import annotations

import math
import threading

__all__ = ["LatencyHistogram", "ServeMetrics"]


class LatencyHistogram:
    """Fixed log-bucket latency histogram (seconds in, seconds out).

    Buckets are geometric: edge[i] = lo * growth**i, covering [lo, hi);
    samples below ``lo`` land in bucket 0, above ``hi`` in the overflow
    bucket (whose reported edge is ``hi``). ~5% relative resolution is
    plenty for p50/p95/p99 gates with multiplicative bounds.
    """

    def __init__(self, lo: float = 1e-5, hi: float = 100.0,
                 growth: float = 1.05):
        self.lo, self.growth = float(lo), float(growth)
        self._log_g = math.log(growth)
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._log_g)) + 1
        self.counts = [0] * (self.n_buckets + 1)    # +1 overflow
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        if s <= self.lo:
            i = 0
        else:
            i = min(int(math.log(s / self.lo) / self._log_g) + 1,
                    self.n_buckets)
        self.counts[i] += 1
        self.n += 1
        self.total += s
        if s > self.max:
            self.max = s

    def _edge(self, i: int) -> float:
        return self.lo * self.growth ** i

    def percentile(self, q: float) -> float:
        """Upper bucket edge at quantile ``q`` in [0, 1]; 0.0 when empty."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                # upper edge, clamped to the observed max so a lone
                # sample cannot report above itself
                return min(self._edge(i), self.max)
        return min(self._edge(self.n_buckets), self.max)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def snapshot_ms(self) -> dict:
        return {"n": self.n,
                "mean_ms": self.mean * 1e3,
                "p50_ms": self.percentile(0.50) * 1e3,
                "p95_ms": self.percentile(0.95) * 1e3,
                "p99_ms": self.percentile(0.99) * 1e3,
                "max_ms": self.max * 1e3}


class ServeMetrics:
    """The service's counters, all behind one lock.

    * ``record_request(latency_s)`` — per completed request (end-to-end:
      enqueue → θ delivered).
    * ``record_batch(n_real, n_slots, queue_depth)`` — per dispatched
      micro-batch: fill ratio = real docs / padded doc slots, and the
      pending-queue depth observed when the batch was cut.
    * ``record_cache(hits, misses)`` — per batch, token-granular.
    * ``record_refresh(staleness_steps, seq)`` — per snapshot swap; the
      current staleness is also re-read by ``snapshot()``.
    * rejected / requeued / failed counters for backpressure and chaos.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.latency = LatencyHistogram()
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.requeued_batches = 0
        self.batches = 0
        self.batch_fill_sum = 0.0
        self.queue_depth_sum = 0
        self.queue_depth_peak = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.refreshes = 0
        self.staleness_steps = 0.0
        self.snapshot_seq = -1

    def record_request(self, latency_s: float) -> None:
        with self._lock:
            self.latency.record(latency_s)
            self.completed += 1

    def record_requests(self, latencies_s) -> None:
        """Batch variant of ``record_request``: one lock acquisition for
        a whole micro-batch of completions (the worker's hot path)."""
        with self._lock:
            for s in latencies_s:
                self.latency.record(s)
            self.completed += len(latencies_s)

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self.rejected += n

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_requeued_batch(self) -> None:
        with self._lock:
            self.requeued_batches += 1

    def record_batch(self, n_real: int, n_slots: int,
                     queue_depth: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_fill_sum += n_real / max(n_slots, 1)
            self.queue_depth_sum += queue_depth
            if queue_depth > self.queue_depth_peak:
                self.queue_depth_peak = queue_depth

    def record_cache(self, hits: int, misses: int) -> None:
        with self._lock:
            self.cache_hits += int(hits)
            self.cache_misses += int(misses)

    def record_refresh(self, staleness_steps: float, seq: int) -> None:
        with self._lock:
            self.refreshes += 1
            self.staleness_steps = float(staleness_steps)
            self.snapshot_seq = int(seq)

    def snapshot(self) -> dict:
        """Plain-dict export: the reference's keys."""
        with self._lock:
            b = max(self.batches, 1)
            tok = self.cache_hits + self.cache_misses
            return {
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "requeued_batches": self.requeued_batches,
                "batches": self.batches,
                "batch_fill": self.batch_fill_sum / b,
                "queue_depth_mean": self.queue_depth_sum / b,
                "queue_depth_peak": self.queue_depth_peak,
                "cache_hit_rate":
                    self.cache_hits / tok if tok else None,
                "refreshes": self.refreshes,
                "staleness_steps": self.staleness_steps,
                "snapshot_seq": self.snapshot_seq,
                "latency": self.latency.snapshot_ms(),
            }
