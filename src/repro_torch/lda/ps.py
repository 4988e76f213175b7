"""Word-sharded parameter server for W with stale-synchronous delta sync.

Port of ``src/repro/lda/ps.py``, whole: it is plain NumPy on the host, so
the port keeps its own copy (importing the reference would pull in JAX).
The protocol, its messages and its arrays are the reference's, bit for
bit; only the chaos hooks come from ``repro_torch.runtime.chaos``.

The replicated distributed path (``repro_torch.lda.distributed``) keeps a full
copy of W on every data shard and all-reduces the per-iteration delta —
the paper's §V-B story, capped at one host's memory.  This module is the
other ``w_sync`` strategy: W is split into contiguous word-range *owner*
shards, workers pull only the page of rows their current token sub-shard
touches, push int32 delta blocks back, and a stale-synchronous clock
bounds how far any worker may run ahead of the slowest.

Everything here is plain NumPy on the host: the server models the
*protocol* (ownership, rounds, commits, journals, recovery), while the
per-token math stays on device inside ``PSDistTrainer``
(``repro_torch.lda.distributed``).  Design notes: DESIGN.md §15.

Consistency model (round-commit SSP)
------------------------------------

One *round* = one sampling epoch over the corpus.  Pushes for round ``c``
queue per ``(worker, owner)`` and the round **commits** — is folded into
the served rows — only once every worker has finished round ``c``.
Because the deltas are int32 histogram diffs, addition commutes and the
commit is order-free.  A pull at clock ``c`` requires
``c - committed <= staleness``; the scheduler never lets a worker start a
round it could not pull for.

At ``staleness=0`` this is bitwise-equal to the replicated psum path: a
worker opening round ``c`` can only ever observe ``committed == c``
(its own round-``c`` push is missing until it finishes, so
``committed <= c``; the gate forces ``committed >= c``), which is exactly
the state the all-reduce would have broadcast.  Fast workers' early
pushes sit queued and are never visible early.

Recovery surfaces (exercised by the ``-m chaos`` drills):

* **lost push** — ``push_page`` returns an ack; a chaos-dropped push is
  journaled client-side and resent until acked (at-least-once), while a
  per-round ``(worker, seq)`` ledger on the server dedupes replays
  (at-most-once application).
* **owner kill** — an owner's committed rows are wiped;
  ``revive_owner`` restores from the last checkpoint snapshot, replays
  committed rounds from the clients' journals, and re-queues that
  owner's pending (uncommitted) blocks from the same journals.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.runtime import chaos

__all__ = ["OwnerLayout", "ParameterServer", "PSClient", "PushJournal",
           "StalenessViolation"]


class StalenessViolation(RuntimeError):
    """A pull asked for a clock further ahead of the committed round than
    the configured staleness bound allows.  The scheduler in
    ``PSDistTrainer`` never admits such a worker; seeing this raised means
    a protocol bug, not a recoverable condition."""


# ---------------------------------------------------------------------------
# Owner layout: contiguous word ranges that exactly partition [0, V)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OwnerLayout:
    """Contiguous word-range ownership: owner ``o`` holds rows
    ``[starts[o], starts[o+1])`` of W.  The ranges are disjoint and cover
    ``[0, n_words)`` exactly (property-tested in tests/test_ps.py; this
    copy is held to it in tests/test_torch_ps.py).

    ``starts`` has ``n_owners + 1`` entries with ``starts[0] == 0`` and
    ``starts[-1] == n_words``; empty owners (equal consecutive starts)
    are legal when ``n_owners > n_words``.
    """

    n_words: int
    starts: tuple

    def __post_init__(self):
        s = tuple(int(x) for x in self.starts)
        object.__setattr__(self, "starts", s)
        if len(s) < 2 or s[0] != 0 or s[-1] != int(self.n_words):
            raise ValueError(
                f"OwnerLayout.starts must run 0..n_words; got {s[:3]}..."
                f"{s[-3:]} for n_words={self.n_words}")
        if any(b < a for a, b in zip(s, s[1:])):
            raise ValueError("OwnerLayout.starts must be non-decreasing")

    @property
    def n_owners(self) -> int:
        return len(self.starts) - 1

    def range_of(self, owner: int) -> tuple:
        return (self.starts[owner], self.starts[owner + 1])

    def owner_of(self, row: int) -> int:
        """Owner of word row ``row`` (empty owners never match)."""
        if not 0 <= row < self.n_words:
            raise IndexError(f"row {row} outside [0, {self.n_words})")
        o = int(np.searchsorted(np.asarray(self.starts), row, side="right")) - 1
        while self.starts[o + 1] <= row:   # skip empty ranges
            o += 1
        return o

    def owners_touching(self, lo: int, hi: int) -> list:
        """Owners whose range intersects ``[lo, hi)`` (non-empty only)."""
        if lo >= hi:
            return []
        out = []
        for o in range(self.n_owners):
            a, b = self.range_of(o)
            if a < hi and lo < b:
                out.append(o)
        return out

    @classmethod
    def build(cls, n_words: int, n_owners: int, *,
              layout: str = "rows", row_mass=None) -> "OwnerLayout":
        """Split ``[0, n_words)`` into ``n_owners`` contiguous ranges.

        ``layout="rows"`` balances row counts; ``layout="mass"`` balances
        cumulative token mass (``row_mass``, one non-negative weight per
        word row) so hot-word-heavy prefixes don't overload owner 0.
        """
        if n_owners < 1:
            raise ValueError(f"n_owners must be >= 1, got {n_owners}")
        if layout == "rows" or row_mass is None:
            cuts = np.linspace(0, n_words, n_owners + 1)
            starts = tuple(int(round(c)) for c in cuts)
        elif layout == "mass":
            m = np.asarray(row_mass, dtype=np.float64)
            if m.shape != (n_words,):
                raise ValueError(
                    f"row_mass must have shape ({n_words},), got {m.shape}")
            if (m < 0).any():
                raise ValueError("row_mass must be non-negative")
            cum = np.cumsum(m)
            total = cum[-1] if cum.size else 0.0
            if total <= 0:
                return cls.build(n_words, n_owners, layout="rows")
            targets = total * np.arange(1, n_owners) / n_owners
            mids = np.searchsorted(cum, targets, side="left") + 1
            mids = np.minimum(mids, n_words)
            starts = (0,) + tuple(int(x) for x in np.maximum.accumulate(mids))
            starts = starts + (n_words,)
        else:
            raise ValueError(
                f"owner layout must be 'rows' or 'mass', got {layout!r}")
        return cls(n_words=n_words, starts=starts)


# ---------------------------------------------------------------------------
# Client-side push journal: the unacked/committed replay log
# ---------------------------------------------------------------------------

class PushJournal:
    """Per-worker log of pushed delta blocks, kept until a checkpoint
    covers them.  This is the recovery substrate: a lost push is resent
    from here, and a revived owner replays committed rounds from here.

    Blocks accumulate per ``(clock, owner)`` — a worker pushes one page
    per sub-shard, several of which may overlap one owner's range — so
    replay applies each round's *net* per-owner delta exactly once.
    """

    def __init__(self, worker: int, layout: OwnerLayout, n_topics: int):
        self.worker = int(worker)
        self.layout = layout
        self.n_topics = int(n_topics)
        self.rounds: dict = {}      # clock -> {owner: (R_o, K) int32}
        self.next_seq = 0

    def record(self, clock: int, lo: int, hi: int, block) -> int:
        """Fold a page delta ``block`` (rows [lo, hi)) into the journal,
        returning the wire sequence number for this push."""
        blk = np.asarray(block, dtype=np.int32)
        if blk.shape != (hi - lo, self.n_topics):
            raise ValueError(
                f"push block shape {blk.shape} != ({hi - lo}, {self.n_topics})")
        per_owner = self.rounds.setdefault(int(clock), {})
        for o in self.layout.owners_touching(lo, hi):
            a, b = self.layout.range_of(o)
            cl, ch = max(lo, a), min(hi, b)
            dst = per_owner.get(o)
            if dst is None:
                dst = np.zeros((b - a, self.n_topics), dtype=np.int32)
                per_owner[o] = dst
            dst[cl - a:ch - a] += blk[cl - lo:ch - lo]
        seq = self.next_seq
        self.next_seq += 1
        return seq

    def blocks_for(self, clock: int, owner: int):
        """This worker's net round-``clock`` delta for ``owner`` (or None)."""
        return self.rounds.get(int(clock), {}).get(int(owner))

    def trim(self, through_clock: int) -> None:
        """Drop rounds ``<= through_clock`` — a durable checkpoint now
        covers them, so they can never need replaying again."""
        for c in [c for c in self.rounds if c <= int(through_clock)]:
            del self.rounds[c]

    def nbytes(self) -> int:
        return sum(b.nbytes for per in self.rounds.values()
                   for b in per.values())


# ---------------------------------------------------------------------------
# The server: committed rows per owner + the round-commit clock
# ---------------------------------------------------------------------------

class ParameterServer:
    """Host-side word-sharded W store with round-commit SSP semantics.

    Owner ``o`` stores its rows as a dense ``(R_o, K)`` int32 block —
    dense because this is the *storage* shard (sparse packing is a wire /
    device-memory concern, handled by HybridW on the trainer side), and
    each host only ever holds ``1/n_owners`` of V rows.
    """

    def __init__(self, layout: OwnerLayout, n_topics: int, n_workers: int,
                 *, staleness: int = 0):
        self.layout = layout
        self.n_topics = int(n_topics)
        self.n_workers = int(n_workers)
        self.staleness = int(staleness)
        K = self.n_topics
        self.rows = [np.zeros((b - a, K), dtype=np.int32)
                     for a, b in (layout.range_of(o)
                                  for o in range(layout.n_owners))]
        self.committed = 0
        # pending[clock][owner] -> summed (R_o, K) int32 not yet committed
        self.pending: dict = {}
        # finished[clock] -> set of workers whose round-``clock`` pushes
        # have all arrived (the commit precondition)
        self.finished: dict = {}
        # seen[clock] -> set of (worker, seq): the replay-dedup ledger
        self.seen: dict = {}
        self.dead: set = set()
        # checkpoint snapshot: the owner rows + clock a restore starts from
        self.ckpt_clock = 0
        self.ckpt_rows = [r.copy() for r in self.rows]

    # -- bootstrap ----------------------------------------------------------

    def load_global(self, W) -> None:
        """Scatter a full ``(V, K)`` int32 W into the owner shards and
        reset the clock — initial state is 'round 0 committed'."""
        W = np.asarray(W, dtype=np.int32)
        if W.shape != (self.layout.n_words, self.n_topics):
            raise ValueError(
                f"W shape {W.shape} != ({self.layout.n_words}, "
                f"{self.n_topics})")
        for o in range(self.layout.n_owners):
            a, b = self.layout.range_of(o)
            self.rows[o] = W[a:b].copy()
        self.pending.clear()
        self.finished.clear()
        self.seen.clear()
        self.dead.clear()
        self.note_checkpoint(self.committed, journals=())

    # -- reads --------------------------------------------------------------

    def can_pull(self, clock: int) -> bool:
        return int(clock) - self.committed <= self.staleness

    def pull_page(self, lo: int, hi: int, *, clock: int) -> np.ndarray:
        """Committed rows ``[lo, hi)`` as a fresh ``(hi-lo, K)`` int32
        page.  Gated by the staleness bound."""
        if not self.can_pull(clock):
            raise StalenessViolation(
                f"pull at clock {clock} with committed={self.committed} "
                f"exceeds staleness={self.staleness}")
        lo, hi = int(lo), int(hi)
        if not (0 <= lo <= hi <= self.layout.n_words):
            raise IndexError(f"page [{lo}, {hi}) outside W")
        out = np.empty((hi - lo, self.n_topics), dtype=np.int32)
        for o in self.layout.owners_touching(lo, hi):
            if o in self.dead:
                raise RuntimeError(
                    f"W owner {o} is dead; revive_owner must run first")
            a, b = self.layout.range_of(o)
            cl, ch = max(lo, a), min(hi, b)
            out[cl - lo:ch - lo] = self.rows[o][cl - a:ch - a]
        return out

    def pull_colsum(self, *, clock: int) -> np.ndarray:
        """Per-topic global column sum of committed W, as int32 — the sum
        of each live owner's part.  Exact in f32 downstream while total
        token count stays below 2**24 (DESIGN.md §15)."""
        if not self.can_pull(clock):
            raise StalenessViolation(
                f"colsum pull at clock {clock} with "
                f"committed={self.committed} exceeds "
                f"staleness={self.staleness}")
        acc = np.zeros((self.n_topics,), dtype=np.int64)
        for o in range(self.layout.n_owners):
            if o in self.dead:
                raise RuntimeError(
                    f"W owner {o} is dead; revive_owner must run first")
            acc += self.rows[o].sum(axis=0, dtype=np.int64)
        return acc.astype(np.int32)

    # -- writes -------------------------------------------------------------

    def push_page(self, worker: int, clock: int, seq: int,
                  lo: int, hi: int, block) -> bool:
        """Queue a page delta for round ``clock``.  Returns the ack; a
        chaos-planned lost push returns False *without* applying (the
        client resends from its journal).  Duplicate ``(worker, seq)``
        deliveries ack True without re-applying."""
        worker, clock = int(worker), int(clock)
        key = (worker, int(seq))
        ledger = self.seen.setdefault(clock, set())
        if key in ledger:
            return True                      # duplicate of an applied push
        if chaos.armed() and chaos.ps_push_lost(worker, clock):
            return False                     # dropped on the wire
        ledger.add(key)
        blk = np.asarray(block, dtype=np.int32)
        lo, hi = int(lo), int(hi)
        per_owner = self.pending.setdefault(clock, {})
        for o in self.layout.owners_touching(lo, hi):
            a, b = self.layout.range_of(o)
            cl, ch = max(lo, a), min(hi, b)
            dst = per_owner.get(o)
            if dst is None:
                dst = np.zeros((b - a, self.n_topics), dtype=np.int32)
                per_owner[o] = dst
            dst[cl - a:ch - a] += blk[cl - lo:ch - lo]
        return True

    def finish_round(self, worker: int, clock: int) -> None:
        """Worker ``worker`` declares all its round-``clock`` pushes sent
        and acked.  When every worker has, the round commits."""
        self.finished.setdefault(int(clock), set()).add(int(worker))
        self._try_commit()

    def _try_commit(self) -> None:
        while len(self.finished.get(self.committed, ())) == self.n_workers:
            c = self.committed
            per_owner = self.pending.pop(c, {})
            for o, blk in per_owner.items():
                if o in self.dead:
                    continue        # revive_owner re-derives from journals
                self.rows[o] += blk
            del self.finished[c]
            self.seen.pop(c, None)
            self.committed = c + 1

    # -- checkpoint / recovery ---------------------------------------------

    def note_checkpoint(self, clock: int, journals) -> None:
        """A durable checkpoint now covers state through round ``clock``
        (exclusive of pending rounds): snapshot owner rows as the revive
        base and trim every client journal."""
        if int(clock) != self.committed:
            raise ValueError(
                f"checkpoint clock {clock} != committed {self.committed}")
        self.ckpt_clock = self.committed
        self.ckpt_rows = [r.copy() for r in self.rows]
        for j in journals:
            j.trim(self.committed - 1)

    def kill_owner(self, owner: int) -> None:
        """Wipe owner ``owner``'s committed rows (the chaos drill's 'host
        died'); reads fail until ``revive_owner`` runs."""
        o = int(owner)
        a, b = self.layout.range_of(o)
        self.rows[o] = np.zeros((b - a, self.n_topics), dtype=np.int32)
        self.dead.add(o)

    def revive_owner(self, owner: int, journals) -> None:
        """Rebuild a dead owner: checkpoint snapshot + journal replay of
        rounds committed since the snapshot, then re-queue the owner's
        share of any still-pending (uncommitted) rounds.

        ``journals`` must cover every worker — the round-commit rule
        guarantees a committed round's blocks exist in *some* journal
        (journals only trim at checkpoints, which reset the snapshot)."""
        o = int(owner)
        if o not in self.dead:
            raise ValueError(f"owner {o} is not dead")
        if len(journals) != self.n_workers:
            raise ValueError(
                f"revive needs all {self.n_workers} journals, "
                f"got {len(journals)}")
        rows = self.ckpt_rows[o].copy()
        for c in range(self.ckpt_clock, self.committed):
            for j in journals:
                blk = j.blocks_for(c, o)
                if blk is not None:
                    rows += blk
        self.rows[o] = rows
        # Re-queue pending (uncommitted) rounds for this owner from the
        # journals — the in-flight blocks died with the owner's queue.
        for c, per_owner in self.pending.items():
            rebuilt = None
            for j in journals:
                # Only replay what the server had ACKED (journals also
                # hold blocks recorded before a failed push; those are
                # resent by the client itself on the nack path, but by
                # the time a kill is observed every acked push is in the
                # journal too and re-deriving from journals is exact:
                # journal contents == sum of acked pushes once the
                # client's resend loop has drained).
                blk = j.blocks_for(c, o)
                if blk is not None:
                    rebuilt = blk.copy() if rebuilt is None else rebuilt + blk
            if rebuilt is not None:
                per_owner[o] = rebuilt
            else:
                per_owner.pop(o, None)
        self.dead.discard(o)

    # -- introspection ------------------------------------------------------

    def owner_nbytes(self, owner: int) -> int:
        return self.rows[int(owner)].nbytes

    def max_owner_nbytes(self) -> int:
        return max(r.nbytes for r in self.rows) if self.rows else 0

    def gather_global(self) -> np.ndarray:
        """Dense committed ``(V, K)`` W — test/eval convenience; a real
        multi-host deployment never materializes this."""
        out = np.zeros((self.layout.n_words, self.n_topics), dtype=np.int32)
        for o in range(self.layout.n_owners):
            a, b = self.layout.range_of(o)
            out[a:b] = self.rows[o]
        return out


# ---------------------------------------------------------------------------
# The client: one per worker — journals pushes, retries nacks
# ---------------------------------------------------------------------------

class PSClient:
    """Worker-side handle: pulls pages, pushes journaled deltas with
    at-least-once resend, and carries the worker's clock."""

    def __init__(self, server: ParameterServer, worker: int):
        self.server = server
        self.worker = int(worker)
        self.journal = PushJournal(worker, server.layout, server.n_topics)
        self.clock = 0

    def pull_page(self, lo: int, hi: int) -> np.ndarray:
        return self.server.pull_page(lo, hi, clock=self.clock)

    def pull_colsum(self) -> np.ndarray:
        return self.server.pull_colsum(clock=self.clock)

    def push_page(self, lo: int, hi: int, block) -> None:
        """Journal then send; resend on nack until acked.  The journal
        entry is recorded exactly once regardless of wire retries, so a
        revive replay never double-counts."""
        seq = self.journal.record(self.clock, lo, hi, block)
        while not self.server.push_page(
                self.worker, self.clock, seq, lo, hi, block):
            pass                    # nack (chaos drop fires once) -> resend

    def finish_round(self) -> None:
        self.server.finish_round(self.worker, self.clock)
        self.clock += 1

    def can_advance(self) -> bool:
        """May this worker *start* round ``self.clock`` under SSP?"""
        return self.server.can_pull(self.clock)
