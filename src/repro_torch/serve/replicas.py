"""Data-parallel serving replicas, each with its own tables and sweep.

Port of ``src/repro/serve/replicas.py``. A ``Replica`` is one copy of the
serving tables (through ``HotWordCache``) on one device with its packed
fold-in. ``ReplicaSet`` spreads replicas round-robin over the visible
cards, or sizes them from a ``ProcessMesh``'s batch axes when one is
passed (``runtime/sharding.py``); with a single device every replica
shares it, as the reference leaves replicas unpinned there.

One micro-batch, in order (``Replica.infer_packed``):

  * **token packing** (``pack_docs``, the reference's, bitwise): the docs
    concatenated into one flat token list, its length bucketed, pad slots
    at word 0 / doc 0 with mask 0;
  * the pinned hot block and the batch's tail rows concatenated on the
    device;
  * **alias warm start**: the initial topics drawn from the frozen φ_w
    through the per-word alias tables (``mh.alias_draw``);
  * per sweep: the phase-1 skip test from the frozen word stats
    (``three_branch.skip_phase``), survivor compaction
    (``survivor_rank``, ``compact_survivor_indices``) and the survivors
    drawn in fixed-capacity chunks by the ``sample_fused`` kernel
    (``three_branch.run_survivor_chunks`` over ``sample_fused_rows``);
    then the batch D rebuilt by the ``histogram`` kernel's sorted route
    over the docs' tokens, as ``FrozenLDAModel.sweep`` does.

Where the reference compiles a batch into one donated dispatch, the port
runs eagerly and reads the survivor count back once a sweep. Its
randomness is an explicit ``torch.Generator`` seeded from ``(seed, seq)``
(``lda.model.uniforms_generator``), the counterpart of the reference's
``fold_in(key, seq)``: the warm start's uniforms first, then each sweep's,
so a fixed seed, seq and batch draw the same bits on every replica of a
device, cached or not.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import llpt, mh, three_branch
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels.sample_fused import sample_fused_rows
from repro_torch.lda.model import uniforms_generator
from repro_torch.runtime import chaos, sharding
from repro_torch.serve.cache import HotWordCache, WordTables

__all__ = ["Replica", "ReplicaSet", "ReplicaDead", "pack_docs"]


class ReplicaDead(RuntimeError):
    """The targeted replica was killed (chaos or shutdown)."""


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


_TOKEN_GRANULE = 4096


def _pad_tokens(total: int, floor: int) -> int:
    """Token-slot bucket: pow2 up to 4 granules, then granule multiples
    (the reference's buckets)."""
    n = max(total, 1)
    if n <= 4 * _TOKEN_GRANULE:
        return _next_pow2(n, floor=floor)
    return -(-n // _TOKEN_GRANULE) * _TOKEN_GRANULE


class PackedBatch(NamedTuple):
    """Flat token layout for one micro-batch (host-side)."""
    word_ids: np.ndarray        # (N,) int64 MODEL-vocab ids (remapped)
    doc_ids: np.ndarray         # (N,) int32, pad tokens -> doc 0, mask 0
    mask: np.ndarray            # (N,) int32
    n_docs: int                 # padded doc-slot count (pow2 bucket)
    n_real_docs: int


def pack_docs(docs: Sequence[Sequence[int]], *, n_words: int,
              word_map: np.ndarray | None, doc_buckets: Sequence[int],
              token_floor: int = 256) -> PackedBatch:
    """Concatenate docs into one flat bucketed token list (the
    reference's, bitwise).

    Documents arrive in the ORIGINAL vocabulary and are remapped through
    ``word_map`` as ``FrozenLDAModel.prepare_batch`` does; pad slots use
    word 0 / doc 0 with mask 0, so they never touch θ.
    """
    if not len(docs):
        raise ValueError("pack_docs needs at least one document")
    arrs = [np.asarray(d, np.int64).ravel() for d in docs]
    n_real = len(arrs)
    B = next((b for b in doc_buckets if b >= n_real),
             _next_pow2(n_real, floor=max(doc_buckets)))
    lens = np.array([a.size for a in arrs], np.int64)
    total = int(lens.sum())
    N = _pad_tokens(total, token_floor)
    word_ids = np.zeros(N, np.int64)
    doc_ids = np.zeros(N, np.int32)
    mask = np.zeros(N, np.int32)
    if total:
        flat = np.concatenate(arrs)
        if flat.min() < 0 or flat.max() >= n_words:
            bad = next(i for i, a in enumerate(arrs) if a.size
                       and (a.min() < 0 or a.max() >= n_words))
            raise ValueError(
                f"doc {bad} has word ids outside [0, {n_words}): "
                "documents must use the training vocabulary")
        word_ids[:total] = flat if word_map is None \
            else np.asarray(word_map, np.int64)[flat]
    doc_ids[:total] = np.repeat(np.arange(n_real, dtype=np.int32), lens)
    mask[:total] = 1
    return PackedBatch(word_ids, doc_ids, mask, B, n_real)


class _DevBatch(NamedTuple):
    """A packed batch on the replica's device, its word ids local to the
    assembled tables."""
    word: torch.Tensor          # (N,) int32 local ids
    doc: torch.Tensor           # (N,) int32
    mask: torch.Tensor          # (N,) int32
    real: torch.Tensor          # (N,) bool
    n_docs: int
    n_tok: int                  # real tokens: the first n_tok slots
    plan: object                # the sorted histogram's plan, or None


class Replica:
    """One serving worker on one device: its tables and its sweep."""

    def __init__(self, rid: int, model, *, device=None,
                 hot_words: int | None = None, warm_start: bool = True,
                 tile_size: int | None = None):
        self.rid = rid
        self.alive = True
        self.n_words = model.n_words
        self.n_topics = model.n_topics
        self.word_map = model.word_map
        self.g = model.g
        self.alpha = float(model.alpha)
        self.tile_size = int(tile_size or model.tile_size)
        self.warm_start = bool(warm_start)
        self.cache = HotWordCache(model, hot_words=hot_words,
                                  warm_start=warm_start, device=device)
        self.device = self.cache.device
        self.batches_done = 0

    # -- the packed fold-in ---------------------------------------------------

    def tables(self, asm) -> WordTables:
        """The pinned head, with the batch's tail rows uploaded and
        concatenated on the device when it has any."""
        if not asm.tail_args:
            return asm.tables
        return WordTables.from_args([
            torch.cat([h, t.to(self.device, non_blocking=True)])
            for h, t in zip(asm.tables.as_args(), asm.tail_args)])

    def device_batch(self, packed: PackedBatch,
                     local_ids: np.ndarray) -> _DevBatch:
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731,E501
        n_tok = int(packed.mask.sum())
        doc = up(packed.doc_ids)
        plan = None
        if _hist.sorted_route_fits(self.n_topics):
            # the docs' tokens come first, sorted by doc; pads follow
            plan = _hist.plan_row_blocks(
                _hist.row_offsets(doc[:n_tok], packed.n_docs), self.n_topics)
        mask = up(packed.mask)
        return _DevBatch(up(local_ids), doc, mask, mask > 0, packed.n_docs,
                         n_tok, plan)

    def counts(self, tb: _DevBatch, topics: torch.Tensor) -> torch.Tensor:
        """(B, K) doc-topic counts of the batch's real tokens through the
        ``histogram`` kernel (sorted route; any order past its K)."""
        n = tb.n_tok
        if tb.plan is None:
            return _hist.histogram(tb.doc, topics, tb.mask, n_rows=tb.n_docs,
                                   n_topics=self.n_topics)
        return _hist.histogram_sorted(topics[:n], tb.mask[:n], tb.plan)

    def sweep(self, tb: _DevBatch, tables: WordTables, u: torch.Tensor,
              topics: torch.Tensor, D: torch.Tensor):
        """One sweep from ``topics`` (batch counts ``D``) with uniforms
        ``u``: (new topics, new D, skip fraction). Every real token reads
        the sweep-start counts; the skipped (and the pads) take K1."""
        dec = three_branch.skip_phase(u, tb.word, tb.doc, D, tables.stats,
                                      g=self.g, alpha=self.alpha)
        skip = dec.skip | ~tb.real
        n = int(u.shape[0])
        capacity = min(n, _next_pow2(max(n // 8, 1), floor=64))
        n_chunks = max(1, -(-n // capacity))
        rank, n_surv = three_branch.survivor_rank(skip)
        surv_idx = three_branch.compact_survivor_indices(
            rank, skip, n_chunks * capacity)
        st = tables.stats
        k1_a1_q = (st.k[:, 0].contiguous(), st.a[:, 0].contiguous(),
                   st.q_prime)

        def sample_chunk(idx):
            return sample_fused_rows(u[idx], tb.doc[idx], tb.word[idx], D,
                                     tables.w_hat, *k1_a1_q,
                                     alpha=self.alpha)[0], None

        new_topics, _ = three_branch.run_survivor_chunks(
            surv_idx, n_surv, dec.k1, capacity=capacity, n_chunks=n_chunks,
            sample_chunk=sample_chunk)
        n_real = max(tb.n_tok, 1)
        frac = (dec.skip & tb.real).sum().float() / n_real
        return new_topics, self.counts(tb, new_topics), frac

    def infer_packed(self, packed: PackedBatch, seed: int, *,
                     n_sweeps: int, seq: int = 0, with_llpt: bool = True
                     ) -> tuple[np.ndarray, float, dict]:
        """(θ rows of the real docs, batch LLPT, accounting dict).

        The batch draws from ``uniforms_generator(seed, seq)``;
        ``with_llpt=False`` skips the diagnostic LLPT (an extra
        tokens × K pass)."""
        if not self.alive:
            raise ReplicaDead(f"replica {self.rid} is dead")
        asm = self.cache.assemble(packed.word_ids)
        tables = self.tables(asm)
        tb = self.device_batch(packed, asm.local_ids)
        K, n = self.n_topics, int(packed.word_ids.shape[0])
        gen = uniforms_generator(seed, seq, self.device)
        if self.warm_start:
            u0 = torch.rand((1, 2, n), generator=gen, device=self.device)
            topics = mh.alias_draw(u0, tb.word, tables.prob, tables.alias,
                                   n_topics=K)[0]
        else:
            topics = torch.randint(0, K, (n,), generator=gen,
                                   device=self.device, dtype=torch.int32)
        D = self.counts(tb, topics)
        for _ in range(int(n_sweeps)):
            u = torch.rand(n, generator=gen, device=self.device)
            topics, D, _skip = self.sweep(tb, tables, u, topics, D)
        len_d = D.sum(dim=1, dtype=torch.float32)
        theta = (D.float() + self.alpha) / (len_d[:, None] + K * self.alpha)
        ll = 0.0
        if with_llpt:
            real = tb.real.nonzero().squeeze(1)
            ll = float(llpt.reduce_ll(llpt.token_ll(
                tb.word[real], tb.doc[real], D, alpha=self.alpha,
                phi=tables.w_hat, tile_size=self.tile_size),
                tb.mask[real]))
        self.batches_done += 1
        return (theta[:packed.n_real_docs].cpu().numpy(), ll,
                {"cache_hits": asm.hits, "cache_misses": asm.misses,
                 "padded_tokens": n, "padded_docs": packed.n_docs})

    def refresh(self, W: np.ndarray) -> None:
        """Adopt a new W snapshot (tear-free: ``HotWordCache.refresh``)."""
        self.cache.refresh(W)

    def kill(self) -> None:
        self.alive = False


class ReplicaSet:
    """N replicas round-robined over the cards, swapped as one unit."""

    def __init__(self, model, *, n_replicas: int = 1, mesh=None,
                 hot_words: int | None = None, warm_start: bool = True):
        if mesh is not None and n_replicas <= 0:
            # one replica per data-parallel slot, the axes the distributed
            # trainer batches over
            n_replicas = sharding.mesh_axis_size(
                mesh, sharding.batch_axes(mesh))
        n_replicas = max(int(n_replicas), 1)
        dev = torch.device(model.device)
        cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        # a single device serves every replica (threads still overlap host
        # prep with the device's work); several cards round-robin
        assign = [None] * n_replicas if cards <= 1 else \
            [torch.device("cuda", i % cards) for i in range(n_replicas)]
        self.replicas = [
            Replica(i, model, device=assign[i], hot_words=hot_words,
                    warm_start=warm_start)
            for i in range(n_replicas)]
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def alive(self) -> list[Replica]:
        return [r for r in self.replicas if r.alive]

    def swap(self, W: np.ndarray) -> None:
        """Refresh every live replica to a new W snapshot (built off the
        serving path, a pointer swap each: in-flight batches keep the
        tables they captured)."""
        with self._lock:
            for r in self.replicas:
                if r.alive:
                    r.refresh(W)

    def chaos_event(self, rid: int) -> str | None:
        """Poll the chaos harness for this replica (no-op un-armed)."""
        if not chaos.armed():
            return None
        return chaos.replica_event(rid)

    def cache_hit_rate(self) -> float | None:
        hits = sum(r.cache.hits for r in self.replicas)
        tok = hits + sum(r.cache.misses for r in self.replicas)
        return hits / tok if tok else None
