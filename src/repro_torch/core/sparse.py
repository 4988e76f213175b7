"""Packed sparse rows for the hybrid state (paper §IV).

Port of ``src/repro/core/sparse.py``:

* **16/16 pair packing**: column index in the high 16 bits, count in the
  low 16 bits of one int32 (paper §IV-B). Once ``idx >= 32768`` the word
  is negative in int32, and ``0xFFFF << 16`` does not fit int32 at all, so
  packing shifts in int64 and narrows with ``.to(torch.int32)`` (two's
  complement wrap, the reference's int32 bits), and unpacking masks
  ``(x >> 16) & 0xFFFF`` (the reference's uint32 view).
* **ELL rows**: ``build_sparse_rows`` (slots by descending count, the
  reference's ``top_k``) and ``pack_rows_sorted`` (slots sorted by column,
  empty slots packed as ``(EMPTY_IDX, 0)`` last).
* **The incremental ELL ops** of the live state (``ell_lookup``,
  ``ell_sub_one``, ``ell_add_one``, ``ell_apply_deltas``,
  ``ell_slot_apply``): a slot is free iff its val is 0, and a freed slot
  keeps its stale idx bits, which every reader ignores.
* **Bucketed rows and the hybrid W** (``BucketedSparse``, ``HybridW``),
  the bucket plan, and the Table I byte models (NumPy, host side).

The reference builds sorted rows without scatters because XLA:CPU prices
a scatter per entry; on the card a scatter or ``torch.searchsorted`` is
cheap, so the port uses whichever is plainest. The integers are the
reference's, bit for bit, the stale idx bits of free slots included.
Every function works on row (or token) blocks of at most
``_ROW_BLOCK_BYTES`` of temporaries, so a 299,752 × 1000 D packs without
gigabytes of int64 index matrices; a batch of ELL updates is still
applied as one batch (``ell_add_one`` ranks inserts over all of it).

Tie rules, where the reference's ``top_k`` and ``argmax`` pick among
equals: ``build_sparse_rows`` keeps equal counts in ascending column
order (a stable descending sort, as ``jax.lax.top_k`` breaks ties), and
every "first slot that matches" is the lowest matching slot, 0 when none
matches (``_first_true``, as ``jnp.argmax`` of a bool row).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "EMPTY_IDX", "pack_pairs", "unpack_pairs",
    "build_sparse_rows", "densify_rows", "sparse_lookup",
    "pack_rows_sorted", "densify_rows_sorted",
    "ell_lookup", "ell_sub_one", "ell_add_one", "ell_apply_deltas",
    "ell_slot_apply",
    "BucketedSparse", "bucket_plan", "build_bucketed",
    "HybridW", "build_hybrid_w",
    "bytes_dense", "bytes_pair_csr", "bytes_bucketed", "bytes_hybrid",
]

EMPTY_IDX = 0xFFFF   # pad idx of sorted rows: sorts after any real column
_MASK = 0xFFFF
_ROW_BLOCK_BYTES = 1 << 28


def pack_pairs(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """(idx, val) -> int32 with idx in the high 16 bits (paper's pairs)."""
    word = (idx.to(torch.int64) << 16) | (val.to(torch.int64) & _MASK)
    return word.to(torch.int32)


def unpack_pairs(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 pairs -> (idx, val), both int32, for the full 16-bit range."""
    idx = (packed >> 16) & _MASK          # arithmetic shift, then mask
    val = packed & _MASK
    return idx, val


def _row_blocks(n_rows: int, bytes_per_row: int):
    step = max(1, _ROW_BLOCK_BYTES // max(bytes_per_row, 1))
    for lo in range(0, n_rows, step):
        yield lo, min(lo + step, n_rows)


def _first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(any, first) of each row of a (C, L) bool mask: ``first`` is the
    lowest True column, 0 for a row with none (``jnp.argmax`` of a bool
    row, whose ties go to the first maximum)."""
    n = mask.shape[1]
    j = torch.arange(n, device=mask.device)
    first = torch.where(mask, j, n).amin(dim=1)
    found = first < n
    return found, torch.where(found, first, 0)


def build_sparse_rows(dense: torch.Tensor, capacity: int) -> torch.Tensor:
    """Dense (R, K) int32 counts -> packed (R, capacity) ELL rows.

    The reference's ``top_k`` by count: slots hold the ``capacity``
    largest counts in descending order, equal counts in ascending column
    order, so a row with fewer nonzeros fills its remaining slots with
    its lowest zero columns (val 0, free). Exact when ``capacity`` is at
    least the row's nnz.
    """
    r, k = dense.shape
    if not 0 <= capacity <= k:
        raise ValueError(f"capacity={capacity} must lie in [0, K={k}]: "
                         "top_k takes at most K entries of a row")
    out = torch.empty((r, capacity), dtype=torch.int32, device=dense.device)
    for lo, hi in _row_blocks(r, 12 * k):
        vals, idxs = torch.sort(dense[lo:hi], dim=1, descending=True,
                                stable=True)
        out[lo:hi] = pack_pairs(idxs[:, :capacity], vals[:, :capacity])
    return out


def pack_rows_sorted(dense: torch.Tensor, capacity: int):
    """Dense (R, K) counts -> ((R, capacity) packed rows sorted by column,
    overflow).

    Empty slots pack as ``(EMPTY_IDX, 0)``. A row with more than
    ``capacity`` nonzeros keeps its lowest columns and drops the rest,
    which the returned 0-d int32 ``overflow`` counts (0 whenever the
    capacity is a row-nnz upper bound, as ``HybridLayout`` sizes it).
    """
    r, k = dense.shape
    dev = dense.device
    out = torch.empty((r, capacity), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.arange(1, capacity + 1, dtype=torch.int32, device=dev)
    for lo, hi in _row_blocks(r, 8 * (k + 2 * capacity)):
        block = dense[lo:hi]
        pos = torch.cumsum(block > 0, dim=1, dtype=torch.int32)   # (b, K)
        nnz = pos[:, -1]
        # the j-th nonzero sits at the first column whose running count
        # reaches j + 1
        cols = torch.searchsorted(
            pos, slots.expand(hi - lo, capacity).contiguous(), side="left")
        cols = torch.clamp(cols, max=k - 1)
        vals = torch.gather(block, 1, cols)
        valid = slots[None, :] <= nnz[:, None]
        out[lo:hi] = pack_pairs(torch.where(valid, cols, EMPTY_IDX),
                                torch.where(valid, vals, 0))
        overflow += torch.clamp(nnz - capacity, min=0).sum()
    return out, overflow.to(torch.int32)


def densify_rows(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Packed rows in any slot order -> dense (R, n_cols) int32.

    Slots with the same column add up; slots whose column lies at or past
    ``n_cols`` (``EMPTY_IDX``) add nothing.
    """
    r, cap = packed.shape
    out = torch.zeros((r, n_cols), dtype=torch.int32, device=packed.device)
    for lo, hi in _row_blocks(r, 12 * cap):
        idx, val = unpack_pairs(packed[lo:hi])
        keep = idx < n_cols
        out[lo:hi].scatter_add_(1, torch.where(keep, idx, 0).long(),
                                torch.where(keep, val, 0))
    return out


def sparse_lookup(packed_row: torch.Tensor, col) -> torch.Tensor:
    """Count at ``col`` in one packed row: the sum of the vals whose idx
    matches (a free slot's val is 0)."""
    idx, val = unpack_pairs(packed_row)
    return torch.where(idx == col, val, 0).sum().to(torch.int32)


def densify_rows_sorted(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Inverse of ``pack_rows_sorted``. A scatter does not need the slots
    sorted, so this is ``densify_rows``; the name keeps the reference's
    pairing of the two."""
    return densify_rows(packed, n_cols)


# ---------------------------------------------------------------------------
# incremental packed-ELL updates (the live-state ops)
#
# A slot is FREE iff its val is 0; a freed slot's idx bits are stale and
# every reader ignores them. A live column holds exactly one slot of its
# row. Each op takes a batch of (row, col) updates, duplicates included:
# every entry finds its slot in the same pre-state, so duplicates land on
# one slot and their adds accumulate. The per-entry slot searches run in
# token blocks; the scatters apply the whole batch at once.
# ---------------------------------------------------------------------------

def _live_slots(packed: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor):
    """(has, slot): whether row ``rows[i]`` holds ``cols[i]`` in a live
    slot, and that slot (0 when not)."""
    c, n = rows.shape[0], packed.shape[1]
    has = torch.zeros(c, dtype=torch.bool, device=packed.device)
    slot = torch.zeros(c, dtype=torch.int64, device=packed.device)
    for lo, hi in _row_blocks(c, 16 * n):
        idx, val = unpack_pairs(packed[rows[lo:hi]])
        has[lo:hi], slot[lo:hi] = _first_true(
            (idx == cols[lo:hi, None]) & (val > 0))
    return has, slot


def ell_lookup(packed: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """Batched count lookup: counts of ``cols`` in packed ELL ``rows``.

    packed (R, L); rows (C,); cols (C,) or (C, G). Returns int32 (C,) or
    (C, G); free slots contribute 0.
    """
    c = rows.shape[0]
    out = torch.empty(tuple(cols.shape), dtype=torch.int32,
                      device=packed.device)
    cols2 = cols[:, None] if cols.dim() == 1 else cols
    for lo, hi in _row_blocks(c, 12 * packed.shape[1] * cols2.shape[1]):
        idx, val = unpack_pairs(packed[rows[lo:hi].long()])
        hit = idx[:, None, :] == cols2[lo:hi, :, None]
        got = torch.where(hit, val[:, None, :], 0).sum(dim=2)
        out[lo:hi] = got[:, 0] if cols.dim() == 1 else got
    return out


def ell_sub_one(packed: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                weight: torch.Tensor):
    """−1 at each weighted (row, col); a slot reaching val 0 becomes free.

    ``weight`` in {0, 1} gates each update. Rows are clipped, so an
    out-of-range row with weight 0 is safe. Returns (packed, n_missing):
    n_missing counts weighted updates whose column held no live slot,
    impossible in a state consistent with its topics (a tripwire).
    """
    n_rows = packed.shape[0]
    w = weight.to(torch.int32)
    rc = torch.clamp(rows.long(), 0, n_rows - 1)
    has, slot = _live_slots(packed, rc, cols)
    out = packed.clone()
    # val sits in the low 16 bits and is > 0 wherever the add is −1, so
    # the int32 subtraction never borrows into the idx bits
    out.index_put_((rc, slot), -(w * has), accumulate=True)
    return out, (w * ~has).sum().to(torch.int32)


def ell_add_one(packed: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                weight: torch.Tensor):
    """+1 at each weighted (row, col), inserting new columns into free
    slots.

    Live columns add in place. New (row, col) pairs are grouped by a
    stable lexicographic sort, and each distinct pair takes its row's
    rank-th free slot (free slots counted in slot order) with the count
    of its duplicates, so concurrent inserts into one row take distinct
    slots, the lowest free ones first. An insert that finds no free slot
    is dropped and counted in the returned n_overflow (0 when capacities
    are row-nnz bounds). Returns (packed, n_overflow).
    """
    n_rows = packed.shape[0]
    c = rows.shape[0]
    dev = packed.device
    w = weight.to(torch.int32)
    rc = torch.clamp(rows.long(), 0, n_rows - 1)
    cols = cols.long()
    has, slot = _live_slots(packed, rc, cols)
    out = packed.clone()
    out.index_put_((rc, slot), w * has, accumulate=True)
    if c == 0:
        return out, torch.zeros((), dtype=torch.int32, device=dev)

    # -- inserts: group by (row, col), then a free slot per distinct pair
    ins = (w > 0) & ~has
    row_key = torch.where(ins, rc, n_rows)              # the rest sort last
    o1 = torch.sort(cols, stable=True).indices
    order = o1[torch.sort(row_key[o1], stable=True).indices]
    rs, cs, ws = row_key[order], cols[order], ins[order]
    newrow = torch.ones(c, dtype=torch.bool, device=dev)
    newrow[1:] = rs[1:] != rs[:-1]
    first = newrow.clone()
    first[1:] |= cs[1:] != cs[:-1]
    uniq = ws & first
    ucum = torch.cumsum(uniq, 0)                        # inclusive
    pre = ucum - uniq.long()                            # exclusive
    # distinct pairs before each row, carried from the row's first entry
    base = torch.cummax(torch.where(newrow & ws, pre, -1), 0).values
    rank = ucum - 1 - base                              # rank in its row
    uix = torch.clamp(ucum - 1, 0, c - 1)               # the pair's group
    cnt = torch.zeros(c, dtype=torch.int64, device=dev).index_add_(
        0, uix, ws.long())[uix]                         # its duplicates
    # the rank-th free slot of the pre-state row (the live adds above
    # never free a slot)
    okslot = torch.zeros(c, dtype=torch.bool, device=dev)
    slot_ins = torch.zeros(c, dtype=torch.int64, device=dev)
    for lo, hi in _row_blocks(c, 16 * packed.shape[1]):
        free = (packed[rc[order[lo:hi]]] & 0xFFFF) == 0
        cfree = torch.cumsum(free, 1)
        okslot[lo:hi], slot_ins[lo:hi] = _first_true(
            free & (cfree == rank[lo:hi, None] + 1))
    do = (uniq & okslot).nonzero().squeeze(1)
    n_overflow = torch.where(uniq & ~okslot, cnt, 0).sum().to(torch.int32)
    out[rs[do], slot_ins[do]] = pack_pairs(cs[do], cnt[do])
    return out, n_overflow


def ell_apply_deltas(packed: torch.Tensor, rows: torch.Tensor,
                     old_cols: torch.Tensor, new_cols: torch.Tensor,
                     weight: torch.Tensor):
    """The ±1 topic-move update: −1 at (row, old), +1 at (row, new).

    Decrements run first, so a slot they free takes an insert of the same
    batch. Densified, the result equals the dense scatter
    (``esca.delta_update_counts``). Returns (packed, n_dropped), n_dropped
    = missing + overflow.
    """
    packed, missing = ell_sub_one(packed, rows, old_cols, weight)
    packed, overflow = ell_add_one(packed, rows, new_cols, weight)
    return packed, missing + overflow


def ell_slot_apply(packed: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Add a dense (R, K) delta to the LIVE slots of packed (R, L) rows.

    Columns with no live slot are untouched (inserts need a free slot:
    ``ell_add_one`` or a ``pack_rows_sorted`` repack); a live slot driven
    to 0 becomes free.
    """
    r, n = packed.shape
    k = delta.shape[1]
    out = torch.empty_like(packed)
    for lo, hi in _row_blocks(r, 24 * n):
        block = packed[lo:hi]
        idx, val = unpack_pairs(block)
        d_at = torch.gather(delta[lo:hi], 1,
                            torch.clamp(idx, max=k - 1).long())
        # the low 16 bits adjust; no borrow, since val + delta >= 0
        out[lo:hi] = block + torch.where(val > 0, d_at, 0)
    return out


def bucket_plan(row_nnz_upper: np.ndarray, max_capacity: int,
                min_capacity: int = 8) -> list[tuple[int, int, int]]:
    """[(row_start, row_end, capacity)] with capacities halving.

    ``row_nnz_upper`` must be non-increasing (guaranteed after frequency
    relabeling since nnz(row) <= token_count(word)).
    """
    if not np.all(np.diff(row_nnz_upper) <= 0):
        raise ValueError(
            "bucket_plan requires row_nnz_upper sorted non-increasing: run "
            "corpus.relabel_by_frequency first so heavy rows get small ids "
            "(the bucket capacities assume nnz bounds decay with row id)")
    plans: list[tuple[int, int, int]] = []
    start = 0
    n = len(row_nnz_upper)
    cap = max_capacity
    while start < n:
        cap = max(min_capacity, cap)
        nxt = cap // 2
        if nxt >= min_capacity:
            # rows whose upper bound still exceeds nxt stay in this bucket
            end = int(np.searchsorted(-row_nnz_upper, -nxt, side="left"))
            end = max(end, start + 1)
        else:
            end = n
        plans.append((start, min(end, n), cap))
        start = min(end, n)
        cap = nxt
    return plans


class BucketedSparse(NamedTuple):
    """Rows grouped into contiguous-id buckets of decaying capacity."""
    buckets: tuple[torch.Tensor, ...]  # each (rows_b, cap_b) packed int32
    row_starts: tuple[int, ...]        # first row id of each bucket
    capacities: tuple[int, ...]

    @property
    def n_rows(self) -> int:
        return sum(int(b.shape[0]) for b in self.buckets)

    def nbytes(self) -> int:
        return sum(int(b.shape[0]) * int(b.shape[1]) * 4
                   for b in self.buckets)


def build_bucketed(dense: torch.Tensor, row_nnz_upper: np.ndarray,
                   max_capacity: int, min_capacity: int = 8
                   ) -> BucketedSparse:
    """Rows of ``dense`` packed by ``build_sparse_rows`` into the buckets
    of ``bucket_plan``, each capacity capped at K."""
    buckets, starts, caps = [], [], []
    for s, e, cap in bucket_plan(row_nnz_upper, max_capacity, min_capacity):
        cap = min(cap, dense.shape[1])
        buckets.append(build_sparse_rows(dense[s:e], cap))
        starts.append(s)
        caps.append(cap)
    return BucketedSparse(tuple(buckets), tuple(starts), tuple(caps))


class HybridW(NamedTuple):
    """W split by the paper's heuristic: dense head rows, bucketed tail."""
    dense: torch.Tensor                # (V_dense, K) int32
    sparse: BucketedSparse             # the tail words
    v_dense: int

    def nbytes(self) -> int:
        return int(self.dense.numel()) * 4 + self.sparse.nbytes()

    def densify(self, n_topics: int) -> torch.Tensor:
        return torch.cat([self.dense] + [densify_rows(b, n_topics)
                                         for b in self.sparse.buckets])


def build_hybrid_w(W: torch.Tensor, word_token_counts: np.ndarray,
                   threshold: int) -> HybridW:
    """Split W by the paper's heuristic: #tokens >= threshold (= K) =>
    dense. Word ids must be frequency-relabeled (counts non-increasing),
    so the split is one row index."""
    counts = np.asarray(word_token_counts)
    if not np.all(np.diff(counts) <= 0):
        raise ValueError(
            "build_hybrid_w requires frequency-relabeled word ids (token "
            "counts non-increasing): call corpus.relabel_by_frequency first "
            "so the dense/sparse split is a single row index")
    v_dense = int(np.searchsorted(-counts, -threshold, side="right"))
    k = W.shape[1]
    tail_upper = np.minimum(counts[v_dense:], k)
    if len(tail_upper):
        sparse = build_bucketed(W[v_dense:], tail_upper,
                                max_capacity=int(min(threshold, k)))
    else:
        sparse = BucketedSparse((), (), ())
    return HybridW(dense=W[:v_dense], sparse=sparse, v_dense=v_dense)


# ---------------------------------------------------------------------------
# memory models (Table I)
# ---------------------------------------------------------------------------

def bytes_dense(n_rows: int, n_cols: int, itemsize: int = 4) -> int:
    return n_rows * n_cols * itemsize


def bytes_pair_csr(row_nnz: np.ndarray, itemsize: int = 4) -> int:
    """Paper's compressed CSR: one packed int32 per nonzero + row offsets."""
    return int(row_nnz.sum()) * itemsize + (len(row_nnz) + 1) * 8


def bytes_bucketed(row_nnz_upper: np.ndarray, max_capacity: int,
                   min_capacity: int = 8, itemsize: int = 4) -> int:
    total = 0
    for s, e, cap in bucket_plan(row_nnz_upper, max_capacity, min_capacity):
        total += (e - s) * cap * itemsize
    return total


def bytes_hybrid(word_token_counts: np.ndarray, n_topics: int,
                 threshold: int | None = None, itemsize: int = 4) -> dict:
    counts = -np.sort(-np.asarray(word_token_counts))
    thr = n_topics if threshold is None else threshold
    v_dense = int(np.searchsorted(-counts, -thr, side="right"))
    dense_b = bytes_dense(v_dense, n_topics, itemsize)
    tail = np.minimum(counts[v_dense:], n_topics)
    sparse_b = bytes_bucketed(tail, int(min(thr, n_topics)),
                              itemsize=itemsize) if len(tail) else 0
    return {"v_dense": v_dense, "dense_bytes": dense_b,
            "sparse_bytes": sparse_b, "total": dense_b + sparse_b}
