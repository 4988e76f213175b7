"""Sparse-S' sampling for tail words: CUDA kernels and their plain twins.

Replaces two TPU kernels of ``src/repro/kernels/sample_sparse.py``:
``sample_sparse`` (``pallas_call`` at line 128) and
``sample_sparse_tiled`` (line 181), and on the main path's entries also
the reference's Q' finish (``src/repro/kernels/ops.py`` ``_q_fallback``).
Per token it draws over the packed sparse D row (``idx<<16 | val`` per
slot, paper §IV-B) in O(live slots): the M branch, or the first live slot
whose running S' mass crosses the draw, or — for draws past M + S' — the
Q' branch. A slot is live when val > 0, idx < K and idx ≠ K1; only live
slots add mass, and only they may be drawn.

Every entry takes the packed rows sorted by idx, so the empty slots
(``EMPTY_IDX``, val 0) come last, as ``core/sparse.py``
``pack_rows_sorted`` makes them: the first empty slot ends the row, and
the kernel reads nothing past the 32-slot step that holds it.

Entry points:

``sample_sparse_rows(u, doc, word, D_packed, W_hat, k1_w, a1_w, q_prime_w,
  b1, alpha=)`` — the main path's. The kernel reads the packed D row by
  doc, Ŵ at the slot ids and the per-word K1, a1, Q' by word, so no
  (C, L) gather is built, and finishes a Q' token itself: the first topic
  whose running sum of α·Ŵ'[k] exceeds its share of the draw, clamped to
  K−1 (``ref.q_fallback_ref``, the twin).
``sample_sparse_tiled_rows(u, doc, word, tile_first, tile_size, ...,
  win_words=, alpha=)`` — the same through each tile's word window;
  bitwise equal to ``sample_sparse_rows`` for every tile whose word run
  fits the window.
``sample_sparse(u, packed_rows, w_at_idx, k1, a1, b1, q_prime, alpha=)``
  and ``sample_sparse_tiled(...)`` — the reference's signatures on
  pre-gathered rows, kept as the parity entry points; the same kernel
  body, which returns ``topic = -1`` with ``needs_q`` on the Q' branch,
  as the Pallas kernel does (``kernels/ops.py`` finishes it).

Both kernels live in ``csrc/sample_sparse.cu`` (one warp per token, one
shared body, nothing staged, so no cap on L or K), bound by bytes, built
with ``nvcc`` at first use. A wrapper takes its plain twin only for CPU
tensors; for CUDA tensors it launches or raises.
``sample_sparse_rows.launches`` and ``sample_sparse_tiled_rows.launches``
count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparse import EMPTY_IDX, unpack_pairs
from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import q_fallback_ref, sample_sparse_ref
from repro_torch.kernels.sample_fused import _check_tiles, window_rows

__all__ = ["sample_sparse", "sample_sparse_tiled", "sample_sparse_rows",
           "sample_sparse_tiled_rows", "sample_sparse_rows_plain", "build"]

_PLAIN_TILE = 4096         # tokens per gathered tile in the plain twin
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library;
    returns it and the compiler's output."""
    lib, log = nvcc.load("sample_sparse")
    tail = [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
            ctypes.c_longlong, _F, _P]
    lib.sample_sparse_launch.argtypes = [_P, _P, _P] + tail
    lib.sample_sparse_tiled_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I] \
        + tail
    for fn in (lib.sample_sparse_launch, lib.sample_sparse_tiled_launch):
        fn.restype = _I
    lib.sample_sparse_error_string.argtypes = [_I]
    lib.sample_sparse_error_string.restype = ctypes.c_char_p
    return lib, log


def _check(u, doc, word, packed, W, w_at, stats, b1) -> None:
    n = u.shape[0]
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_sparse: unsupported device {u.device}")
    named = [("u", u, torch.float32, 1), ("doc", doc, torch.int32, 1),
             ("word", word, torch.int32, 1),
             ("packed", packed, torch.int32, 2),
             ("k1", stats[0], torch.int32, 1),
             ("a1", stats[1], torch.float32, 1),
             ("q_prime", stats[2], torch.float32, 1),
             ("b1", b1, torch.float32, 1)]
    named.append(("W_hat", W, torch.float32, 2) if w_at is None
                 else ("w_at_idx", w_at, torch.float32, 2))
    for name, t, dtype, ndim in named:
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"sample_sparse: {name} must be a contiguous "
                             f"{ndim}-d {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"sample_sparse: {name} is on {t.device}, u "
                             f"on {u.device}")
    if doc.shape[0] != n or word.shape[0] != n or b1.shape[0] != n:
        raise ValueError("sample_sparse: u, doc, word and b1 differ in "
                         "length")
    n_words = stats[0].shape[0]
    if stats[1].shape[0] != n_words or stats[2].shape[0] != n_words:
        raise ValueError("sample_sparse: k1, a1 and q_prime differ in "
                         "length")
    if w_at is None and W.shape[0] != n_words:
        raise ValueError(f"sample_sparse: W_hat has {W.shape[0]} rows, the "
                         f"word stats {n_words}")
    if w_at is not None and tuple(w_at.shape) != (n, packed.shape[1]):
        raise ValueError(f"sample_sparse: w_at_idx {tuple(w_at.shape)} "
                         f"must be (N, L) = ({n}, {packed.shape[1]})")
    if packed.shape[1] < 1:
        raise ValueError("sample_sparse: packed rows need L >= 1 slots")
    if n:
        d_lo, d_hi, w_lo, w_hi = torch.stack(
            [doc.min(), doc.max(), word.min(), word.max()]).tolist()
        if d_lo < 0 or d_hi >= packed.shape[0] or w_lo < 0 \
                or w_hi >= n_words:
            raise ValueError("sample_sparse: a doc or word id lies outside "
                             "the packed rows or the word stats")


def _plain(u, doc, word, packed, W, w_at, stats, b1, alpha):
    """Plain twin of both kernels, on the words each token reads (for the
    tiled kernel, through its window): with ``W`` (the main path's
    entries) the Q' tokens are finished as in the kernel, with ``w_at``
    they keep topic -1."""
    k1_w, a1_w, qp_w = stats
    n = u.shape[0]
    dev = u.device
    topic = torch.empty(n, dtype=torch.int32, device=dev)
    needs_q = torch.empty(n, dtype=torch.bool, device=dev)
    s = torch.empty(n, dtype=torch.float32, device=dev)
    for lo in range(0, n, _PLAIN_TILE):
        hi = min(lo + _PLAIN_TILE, n)
        v = word[lo:hi].long()
        idx, val = unpack_pairs(packed[doc[lo:hi].long()])
        if w_at is None:
            k = W.shape[1]
            w = torch.where(idx < k, W[v[:, None], torch.clamp(idx, max=k - 1)
                                       .long()], 0.0)
        else:
            w = w_at[lo:hi]
        t, q, s[lo:hi] = sample_sparse_ref(
            u[lo:hi], idx, val, w, k1_w[v], a1_w[v], b1[lo:hi], qp_w[v],
            alpha=alpha)
        f = q.nonzero().squeeze(1)
        if w_at is None and f.numel():
            vf, tf = v[f], f + lo
            t[f] = q_fallback_ref(u[tf], t[f], q[f], s[tf], W[vf], k1_w[vf],
                                  a1_w[vf], b1[tf], qp_w[vf], alpha)[0]
        topic[lo:hi], needs_q[lo:hi] = t, q
    return topic, needs_q, s


def sample_sparse_rows_plain(u, doc, word, D_packed, W_hat, k1_w, a1_w,
                             q_prime_w, b1, *, alpha: float):
    """The main-path kernel's plain twin, on any device: gather tile by
    tile, ``ref.sample_sparse_ref``, then ``ref.q_fallback_ref`` on the
    Q' tokens; empty slots add nothing."""
    return _plain(u, doc, word, D_packed, W_hat, None,
                  (k1_w, a1_w, q_prime_w), b1, alpha)


def _launch(entry, u, doc, word, window, packed, W, w_at, stats, b1,
            alpha):
    lib, _ = build()
    n, L = u.shape[0], packed.shape[1]
    dev = u.device
    topic = torch.empty(n, dtype=torch.int32, device=dev)
    needs_q = torch.empty(n, dtype=torch.bool, device=dev)
    s = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return topic, needs_q, s
    rows = (packed.data_ptr(), L,
            None if W is None else W.data_ptr(),
            EMPTY_IDX if W is None else W.shape[1],
            None if w_at is None else w_at.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            u.data_ptr(), doc.data_ptr(), word.data_ptr(), *window, *rows,
            *(t.data_ptr() for t in stats), b1.data_ptr(), topic.data_ptr(),
            needs_q.data_ptr(), s.data_ptr(), n, float(alpha), stream)
    if code != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.sample_sparse_error_string(code).decode())
    return topic, needs_q, s


def _untiled(u, doc, word, packed, W, w_at, stats, b1, alpha):
    _check(u, doc, word, packed, W, w_at, stats, b1)
    if u.device.type == "cpu":
        return _plain(u, doc, word, packed, W, w_at, stats, b1, alpha)
    out = _launch("sample_sparse_launch", u, doc, word, (), packed, W, w_at,
                  stats, b1, alpha)
    if u.shape[0]:
        sample_sparse_rows.launches += 1
    return out


def _tiled(u, doc, word, tile_first, tile_size, packed, W, w_at, stats, b1,
           win_words, alpha):
    _check(u, doc, word, packed, W, w_at, stats, b1)
    n_words = stats[0].shape[0]
    _check_tiles(u, tile_first, tile_size, win_words, n_words)
    if u.device.type == "cpu":
        rows = window_rows(word.long(), tile_first.long(), tile_size,
                           win_words, n_words)
        return _plain(u, doc, rows, packed, W, w_at, stats, b1, alpha)
    window = (tile_first.data_ptr(), int(tile_size), int(win_words),
              n_words)
    out = _launch("sample_sparse_tiled_launch", u, doc, word, window,
                  packed, W, w_at, stats, b1, alpha)
    if u.shape[0]:
        sample_sparse_tiled_rows.launches += 1
    return out


def sample_sparse_rows(u: torch.Tensor, doc: torch.Tensor,
                       word: torch.Tensor, D_packed: torch.Tensor,
                       W_hat: torch.Tensor, k1_w: torch.Tensor,
                       a1_w: torch.Tensor, q_prime_w: torch.Tensor,
                       b1: torch.Tensor, *, alpha: float):
    """Sparse three-branch draw for N tail tokens over packed D rows
    ``D_packed[doc]``, the Q' branch finished.

    Args: u (N,) f32; doc, word (N,) int32; D_packed (M, L) int32, each
    row sorted by idx with its empty slots last (``pack_rows_sorted``);
    W_hat (V, K) f32; k1_w (V,) int32, a1_w and q_prime_w (V,) f32 per
    word; b1 (N,) f32 = D[doc][K1]. Returns (topic int32, needs_q bool,
    S' f32): needs_q marks the tokens whose topic came from the Q' branch.
    """
    return _untiled(u, doc, word, D_packed, W_hat, None,
                    (k1_w, a1_w, q_prime_w), b1, alpha)


sample_sparse_rows.launches = 0


def sample_sparse_tiled_rows(u: torch.Tensor, doc: torch.Tensor,
                             word: torch.Tensor, tile_first: torch.Tensor,
                             tile_size: int, D_packed: torch.Tensor,
                             W_hat: torch.Tensor, k1_w: torch.Tensor,
                             a1_w: torch.Tensor, q_prime_w: torch.Tensor,
                             b1: torch.Tensor, *, win_words: int,
                             alpha: float):
    """``sample_sparse_rows`` with the per-word values (and the Ŵ row)
    read through each tile's word window; token t lies in tile
    ``t // tile_size``, whose run starts at ``tile_first[tile]``. The
    rows are sorted by idx, empty slots last; the Q' branch is
    finished."""
    return _tiled(u, doc, word, tile_first, tile_size, D_packed, W_hat,
                  None, (k1_w, a1_w, q_prime_w), b1, win_words, alpha)


sample_sparse_tiled_rows.launches = 0


def sample_sparse(u: torch.Tensor, packed_rows: torch.Tensor,
                  w_at_idx: torch.Tensor, k1: torch.Tensor, a1: torch.Tensor,
                  b1: torch.Tensor, q_prime: torch.Tensor, *, alpha: float):
    """The reference's signature: pre-gathered (N, L) packed rows (sorted
    by idx, empty slots last) and Ŵ at their slots, per-token stats. The
    same kernel with doc = word = arange(N); a Q' token gets topic -1 and
    needs_q, as in the Pallas kernel. Returns (topic, needs_q, S')."""
    n = packed_rows.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=packed_rows.device)
    return _untiled(u, ids, ids, packed_rows, None, w_at_idx,
                    (k1, a1, q_prime), b1, alpha)


def sample_sparse_tiled(u: torch.Tensor, packed_rows: torch.Tensor,
                        w_at_idx: torch.Tensor, word_ids: torch.Tensor,
                        first_word, k1_w: torch.Tensor, a1_w: torch.Tensor,
                        q_prime_w: torch.Tensor, b1: torch.Tensor, *,
                        alpha: float, win_words: int):
    """The reference's tiled signature: one tile of N tokens whose run
    starts at ``first_word``, per-word stats read through its window; the
    packed rows sorted by idx, empty slots last. A Q' token gets topic -1
    and needs_q."""
    n = packed_rows.shape[0]
    dev = packed_rows.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.as_tensor(first_word, dtype=torch.int32).reshape(1).to(dev)
    return _tiled(u, ids, word_ids, first, max(n, 1), packed_rows, None,
                  w_at_idx, (k1_w, a1_w, q_prime_w), b1,
                  min(int(win_words), k1_w.shape[0]), alpha)
