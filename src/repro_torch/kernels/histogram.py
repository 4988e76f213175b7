"""Count-matrix rebuild: a CUDA histogram kernel and its plain twins.

Replaces the TPU kernel ``histogram_partials`` of
``src/repro/kernels/histogram.py`` (``pallas_call`` at line 85) and its
fold ``histogram`` (line 101): the rebuild of W (V, K) from the
word-sorted token list and of D (M, K) from its document-major order
(paper §IV-C). ``csrc/histogram.cu`` runs one block per tile of
``tile_t`` tokens, accumulates the tile's (R × 128) partial in shared
memory and folds it into the output inside the kernel (the reference's
(n_tiles, R, K) partials would take ~100 GB at 100 M tokens).

Entry points:

``histogram(row_ids, topics, weights, n_rows=, n_topics=)`` — the main
  path's: out[row, topic] += weight, (n_rows, n_topics) int32. Rows should
  be sorted (word-sorted T for W; doc-major for D) so each tile's rows lie
  in one narrow window; any order is correct, tokens outside their tile's
  window take a global atomic add. Twin: ``kernels/ref.py``
  ``histogram_ref`` (``index_put_(accumulate=True)``).
``histogram_partials(row_ids, topics, weights, tile_bases, n_topics=)`` —
  the reference's signature: per-tile partials and the ``covered`` mask,
  the fold left to the caller; kept as the parity entry point, it runs the
  same kernel body. Twin: ``ref.histogram_partials_ref``.

The result is integers, so it is bitwise equal whatever the order of the
adds. A wrapper takes its plain twin only for CPU tensors; for CUDA
tensors it launches or raises. ``histogram.launches`` and
``histogram_partials.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import histogram_partials_ref, histogram_ref

__all__ = ["histogram", "histogram_partials", "build", "DEFAULT_TILE_T",
           "DEFAULT_ROWS"]

DEFAULT_TILE_T = 512
DEFAULT_ROWS = 128
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library;
    returns it and the compiler's output."""
    lib, log = nvcc.load("histogram")
    lib.histogram_launch.argtypes = [_P] * 3 + [_L, _I, _I, _I, _L, _P, _P]
    lib.histogram_partials_launch.argtypes = [_P] * 4 + [_L, _I, _I, _I] \
        + [_P] * 3
    for fn in (lib.histogram_launch, lib.histogram_partials_launch):
        fn.restype = _I
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
