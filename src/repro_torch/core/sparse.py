"""Packed sparse rows for the hybrid state (paper §IV).

Port of the parts of ``src/repro/core/sparse.py`` the hybrid fused
iteration runs:

* **16/16 pair packing**: column index in the high 16 bits, count in the
  low 16 bits of one int32 (paper §IV-B). Once ``idx >= 32768`` the word
  is negative in int32, and ``0xFFFF << 16`` does not fit int32 at all, so
  packing shifts in int64 and narrows with ``.to(torch.int32)`` (two's
  complement wrap, the reference's int32 bits), and unpacking masks
  ``(x >> 16) & 0xFFFF`` (the reference's uint32 view).
* **Sorted ELL rows**: each row holds its nonzeros in ``capacity`` slots
  sorted by column, empty slots packed as ``(EMPTY_IDX, 0)``.
* **Bucket plan** of the tail W rows (NumPy, host side).

The reference builds sorted rows without scatters because XLA:CPU prices
a scatter per entry; on the card a scatter or ``torch.searchsorted`` is
cheap, so the port uses whichever is plainest. The integers are the
reference's, bit for bit. Every function works on row blocks of at most
``_ROW_BLOCK_BYTES`` of temporaries, so a 299,752 × 1000 D packs without
gigabytes of int64 index matrices.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["EMPTY_IDX", "pack_pairs", "unpack_pairs", "pack_rows_sorted",
           "densify_rows_sorted", "densify_rows", "bucket_plan"]

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


def densify_rows_sorted(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Inverse of ``pack_rows_sorted``. A scatter does not need the slots
    sorted, so this is ``densify_rows``; the name keeps the reference's
    pairing of the two."""
    return densify_rows(packed, n_cols)


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
