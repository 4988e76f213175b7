"""Count-matrix rebuild: CUDA histogram kernels and their plain twins.

Replaces the TPU kernel ``histogram_partials`` of
``src/repro/kernels/histogram.py`` (``pallas_call`` at line 85) and its
fold ``histogram`` (line 101): the rebuild of W (V, K) from the
word-sorted token list and of D (M, K) from its document-major order
(paper §IV-C). ``csrc/histogram.cu`` has two routes to one result,
out[row, topic] += weight as (n_rows, n_topics) int32 integers, so every
route is bitwise equal to ``index_put_(accumulate=True)`` and
``torch.bincount``.

Entry points:

``histogram_sorted(topics, weights, plan)`` — the main path's (W and D
  in ``ops.update_counts``). The rows are sorted and given by their CSR
  offsets (``row_offsets``, static per corpus); ``plan_row_blocks`` cuts
  them once into blocks of whole rows with a few thousand tokens, each
  block counting its rows' full K-wide counters in shared memory in one
  pass and storing them once (no zeroing of the output, no global atomic
  for the rows it owns). A row longer than one block's budget is cut into
  pieces that fold into it with global atomics. Twin:
  ``ref.histogram_sorted_ref``, which follows the plan. It needs one row
  of K counters in a block's shared memory (``sorted_route_fits``: K up
  to 58,100); past that ``ops.update_counts`` counts with ``histogram``.
``histogram(row_ids, topics, weights, n_rows=, n_topics=)`` — rows in any
  order: one block per tile of ``tile_t`` tokens, an (R × 128) shared
  partial per block of 128 topics over the tile's row window, folded with
  global atomics; tokens outside the window take a global atomic add.
  Blocked by 128 topics, it takes any K. Twin: ``ref.histogram_ref``.
``histogram_partials(row_ids, topics, weights, tile_bases, n_topics=)`` —
  the reference's signature: per-tile partials and the ``covered`` mask,
  the fold left to the caller; the parity entry point, on the tile body.
  Twin: ``ref.histogram_partials_ref``.

A wrapper takes its plain twin only for CPU tensors; for CUDA tensors it
launches or raises. ``histogram_sorted.launches``, ``histogram.launches``
and ``histogram_partials.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import (histogram_partials_ref, histogram_ref,
                                     histogram_sorted_ref)

__all__ = ["histogram", "histogram_partials", "histogram_sorted",
           "RowBlocks", "row_offsets", "plan_row_blocks", "sorted_route_fits",
           "build", "DEFAULT_TILE_T", "DEFAULT_ROWS", "BLOCK_TOKENS",
           "BLOCK_SMEM"]

DEFAULT_TILE_T = 512
DEFAULT_ROWS = 128
# The sorted route's block: its tokens (a row past this is cut into
# pieces of this many) and its counters' shared memory, ~4 blocks an SM.
BLOCK_TOKENS = 4096
BLOCK_SMEM = 48 * 1024
_MAX_SMEM = 232448               # sm_90: shared bytes one block may take
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class RowBlocks(NamedTuple):
    """The sorted route's plan for one sorted row stream (static per
    corpus and K). Block b owns rows [row_lo, row_hi) and counts tokens
    [tok_lo, tok_hi); it owns its rows outright unless it is a piece of
    a split row (its tokens are then part of its one row's)."""
    row_ptr: torch.Tensor      # (n_rows + 1,) int64 CSR offsets
    blocks: torch.Tensor       # (n_blocks, 4) int64 row_lo, row_hi, tok_lo, tok_hi
    split_rows: torch.Tensor   # (n_split,) int64 rows cut into pieces
    max_rows: int              # rows one block holds at most
    n_topics: int

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1


def _sorted_smem(rows: int, k: int) -> int:
    """Shared bytes of a sorted-route block (``sorted_smem`` in the .cu)."""
    return (rows + 2) // 2 * 16 + (rows * k + 8) * 4


def sorted_route_fits(n_topics: int) -> bool:
    """Whether one row of ``n_topics`` counters fits a sorted-route block
    (K <= 58,100 on sm_90)."""
    return _sorted_smem(1, int(n_topics)) <= _MAX_SMEM


def row_offsets(sorted_rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """CSR offsets (n_rows + 1,) int64 of a sorted row-id stream: row r's
    tokens are [ptr[r], ptr[r+1]); ids outside [0, n_rows) lie outside
    [ptr[0], ptr[n_rows]) and are never counted."""
    probe = torch.arange(n_rows + 1, dtype=sorted_rows.dtype,
                         device=sorted_rows.device)
    return torch.searchsorted(sorted_rows.contiguous(), probe).to(torch.int64)


def plan_row_blocks(row_ptr: torch.Tensor, n_topics: int, *,
                    block_tokens: int = BLOCK_TOKENS,
                    block_smem: int = BLOCK_SMEM) -> RowBlocks:
    """Cut a sorted row stream into the sorted route's blocks.

    A row of more than ``block_tokens`` tokens is split: it gets pieces of
    ``block_tokens``. The other rows are grouped in order; a group ends
    before a split row and where its rows stop sharing a
    ``block_tokens``-wide bucket of start offsets or a bucket of
    ``max_rows`` row ids (``max_rows`` counters rows fit in
    ``block_smem`` bytes), so a group holds at most ``max_rows`` rows and
    fewer than 2·``block_tokens`` tokens. Vectorised torch ops on the
    offsets' device."""
    k = int(n_topics)
    if k < 1 or block_tokens < 1:
        raise ValueError(f"plan_row_blocks: n_topics={k} and block_tokens="
                         f"{block_tokens} must be >= 1")
    max_rows = max(1, block_smem // (4 * k))
    while max_rows > 1 and _sorted_smem(max_rows, k) > _MAX_SMEM:
        max_rows -= 1
    if not sorted_route_fits(k):
        raise ValueError(f"histogram_sorted: one row of K={k} counters "
                         "exceeds a block's shared memory")
    dev = row_ptr.device
    row_ptr = row_ptr.to(torch.int64)
    n_rows = row_ptr.shape[0] - 1
    start, end = row_ptr[:-1], row_ptr[1:]
    split = (end - start) > block_tokens
    r = torch.arange(n_rows, device=dev)
    before = torch.cumsum(split, 0) - split.long()     # split rows before r
    new = torch.ones(n_rows, dtype=torch.bool, device=dev)
    if n_rows > 1:
        new[1:] = (before[1:] != before[:-1]) \
            | (start[1:] // block_tokens != start[:-1] // block_tokens) \
            | (r[1:] // max_rows != r[:-1] // max_rows)
    seg_lo = ((new & ~split) | split).nonzero().squeeze(1)
    seg_hi = torch.cat([seg_lo[1:], torch.full((1,), n_rows, device=dev,
                                               dtype=torch.int64)])[
        :seg_lo.shape[0]]                       # (no rows: no segment)
    seg_split = split[seg_lo]
    lo_tok, hi_tok = row_ptr[seg_lo], row_ptr[seg_hi]
    pieces = torch.where(seg_split,
                         (hi_tok - lo_tok + block_tokens - 1) // block_tokens,
                         torch.ones_like(lo_tok))
    seg = torch.repeat_interleave(
        torch.arange(seg_lo.shape[0], device=dev), pieces)
    first = torch.cumsum(pieces, 0) - pieces
    p = torch.arange(seg.shape[0], device=dev) - first[seg]
    tok_lo = lo_tok[seg] + p * block_tokens
    tok_hi = torch.where(seg_split[seg],
                         torch.minimum(tok_lo + block_tokens, hi_tok[seg]),
                         hi_tok[seg])
    blocks = torch.stack([seg_lo[seg], seg_hi[seg], tok_lo, tok_hi],
                         dim=1).contiguous()
    return RowBlocks(row_ptr=row_ptr.contiguous(), blocks=blocks,
                     split_rows=split.nonzero().squeeze(1).contiguous(),
                     max_rows=max_rows, n_topics=k)


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library;
    returns it and the compiler's output."""
    lib, log = nvcc.load("histogram")
    lib.histogram_launch.argtypes = [_P] * 3 + [_L, _I, _I, _I, _L, _P, _P]
    lib.histogram_partials_launch.argtypes = [_P] * 4 + [_L, _I, _I, _I] \
        + [_P] * 3
    for fn in (lib.histogram_launch, lib.histogram_partials_launch):
        fn.restype = _I
    lib.histogram_sorted_launch.argtypes = [_P] * 4 + [_L, _P, _L, _I, _I,
                                                       _P, _P]
    lib.histogram_sorted_launch.restype = _I
    lib.histogram_max_rows.argtypes = []
    lib.histogram_max_rows.restype = _I
    lib.histogram_error_string.argtypes = [_I]
    lib.histogram_error_string.restype = ctypes.c_char_p
    return lib, log


def _check(name, row_ids, topics, weights, tile_t, rows_per_tile) -> None:
    n = row_ids.shape[0]
    for label, t in (("row_ids", row_ids), ("topics", topics),
                     ("weights", weights)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous (N,) "
                             f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != row_ids.device:
            raise ValueError(f"{name}: {label} is on {t.device}, row_ids on "
                             f"{row_ids.device}")
    if row_ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {row_ids.device}")
    if tile_t < 1 or rows_per_tile < 1:
        raise ValueError(f"{name}: tile_t={tile_t} and rows_per_tile="
                         f"{rows_per_tile} must be >= 1")


def _launch(lib, entry: str, *args) -> None:
    code = getattr(lib, entry)(*args)
    if code != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.histogram_error_string(code).decode())


def _kernel_lib(rows_per_tile: int):
    lib, _ = build()
    if rows_per_tile > lib.histogram_max_rows():
        raise ValueError(f"histogram: rows_per_tile={rows_per_tile} exceeds "
                         "one block's shared memory")
    return lib


def histogram(row_ids: torch.Tensor, topics: torch.Tensor,
              weights: torch.Tensor, *, n_rows: int, n_topics: int,
              tile_t: int = DEFAULT_TILE_T,
              rows_per_tile: int = DEFAULT_ROWS) -> torch.Tensor:
    """Full count rebuild: out[row_ids[i], topics[i]] += weights[i], as a
    (n_rows, n_topics) int32 matrix. Tokens whose row or topic lies
    outside the matrix add nothing."""
    _check("histogram", row_ids, topics, weights, tile_t, rows_per_tile)
    if row_ids.device.type == "cpu":
        return histogram_ref(row_ids, topics, weights, n_rows=n_rows,
                             n_topics=n_topics)
    lib = _kernel_lib(rows_per_tile)
    out = torch.zeros((n_rows, n_topics), dtype=torch.int32,
                      device=row_ids.device)
    n = row_ids.shape[0]
    if n == 0 or n_rows == 0 or n_topics == 0:
        return out
    with torch.cuda.device(row_ids.device):
        stream = torch.cuda.current_stream(row_ids.device).cuda_stream
        _launch(lib, "histogram_launch", row_ids.data_ptr(),
                topics.data_ptr(), weights.data_ptr(), n, int(tile_t),
                int(rows_per_tile), int(n_topics), int(n_rows),
                out.data_ptr(), stream)
    histogram.launches += 1
    return out


histogram.launches = 0


def histogram_partials(row_ids: torch.Tensor, topics: torch.Tensor,
                       weights: torch.Tensor, tile_bases: torch.Tensor, *,
                       n_topics: int, tile_t: int = DEFAULT_TILE_T,
                       rows_per_tile: int = DEFAULT_ROWS):
    """Per-tile (R × K) partial histograms and the covered mask (the
    reference's signature). ``row_ids`` holds a multiple of ``tile_t``
    tokens; tile c counts its tokens with row in [tile_bases[c],
    tile_bases[c] + R). Returns (partials (n_tiles, R, K) int32, covered
    (N,) bool)."""
    _check("histogram_partials", row_ids, topics, weights, tile_t,
           rows_per_tile)
    n = row_ids.shape[0]
    if n % tile_t:
        raise ValueError(f"histogram_partials: {n} tokens are not a multiple "
                         f"of tile_t={tile_t}; pad them first")
    n_tiles = n // tile_t
    if tile_bases.dtype != torch.int32 or tuple(tile_bases.shape) \
            != (n_tiles,) or not tile_bases.is_contiguous() \
            or tile_bases.device != row_ids.device:
        raise ValueError("histogram_partials: tile_bases must be a "
                         f"contiguous ({n_tiles},) int32 tensor beside "
                         "row_ids")
    if row_ids.device.type == "cpu":
        return histogram_partials_ref(row_ids, topics, weights, tile_bases,
                                      n_topics=n_topics, tile_t=tile_t,
                                      rows_per_tile=rows_per_tile)
    lib = _kernel_lib(rows_per_tile)
    dev = row_ids.device
    partials = torch.zeros((n_tiles, rows_per_tile, n_topics),
                           dtype=torch.int32, device=dev)
    covered = torch.zeros(n, dtype=torch.bool, device=dev)
    if n == 0 or n_topics == 0:
        return partials, covered
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib, "histogram_partials_launch", row_ids.data_ptr(),
                topics.data_ptr(), weights.data_ptr(), tile_bases.data_ptr(),
                n, int(tile_t), int(rows_per_tile), int(n_topics),
                partials.data_ptr(), covered.data_ptr(), stream)
    histogram_partials.launches += 1
    return partials, covered


histogram_partials.launches = 0


def histogram_sorted(topics: torch.Tensor, weights: torch.Tensor,
                     plan: RowBlocks) -> torch.Tensor:
    """Count rebuild of a sorted row stream: out[r, topics[i]] +=
    weights[i] for every token i in [row_ptr[r], row_ptr[r+1]), as a
    (n_rows, K) int32 matrix (K = ``plan.n_topics``). Tokens whose topic
    lies outside [0, K), or that lie outside every row, add nothing."""
    n = topics.shape[0]
    for label, t in (("topics", topics), ("weights", weights)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous():
            raise ValueError(f"histogram_sorted: {label} must be a "
                             f"contiguous (N,) int32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != plan.row_ptr.device:
            raise ValueError(f"histogram_sorted: {label} is on {t.device}, "
                             f"the plan on {plan.row_ptr.device}")
    if topics.device.type not in ("cpu", "cuda"):
        raise ValueError(f"histogram_sorted: unsupported device "
                         f"{topics.device}")
    if plan.n_rows and int(plan.row_ptr[-1]) > n:
        raise ValueError(f"histogram_sorted: the plan's rows end at token "
                         f"{int(plan.row_ptr[-1])}, past the {n} given")
    if topics.device.type == "cpu":
        return histogram_sorted_ref(topics, weights, plan)
    lib, _ = build()
    out = torch.empty((plan.n_rows, plan.n_topics), dtype=torch.int32,
                      device=topics.device)
    if plan.n_rows == 0:
        return out
    with torch.cuda.device(topics.device):
        stream = torch.cuda.current_stream(topics.device).cuda_stream
        _launch(lib, "histogram_sorted_launch", topics.data_ptr(),
                weights.data_ptr(), plan.row_ptr.data_ptr(),
                plan.blocks.data_ptr(), plan.blocks.shape[0],
                plan.split_rows.data_ptr(), plan.split_rows.shape[0],
                int(plan.max_rows), int(plan.n_topics), out.data_ptr(),
                stream)
    histogram_sorted.launches += 1
    return out


histogram_sorted.launches = 0
