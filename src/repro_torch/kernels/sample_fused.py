"""Fused three-branch sampling: CUDA kernels and their plain-PyTorch twins.

Replaces two TPU kernels of ``src/repro/kernels/sample_fused.py``:
``sample_fused`` (``pallas_call`` at line 234) and ``sample_fused_tiled``
(line 304). Per token it computes the exact branch masses (M, S', Q')
from the token's D row, its Ŵ row and its word's K1, a1 and Q', draws
x = u·(M+S'+Q'), and returns K1 when x < M, else the first topic k ≠ K1
whose running sum of (D[k]+α)·Ŵ[k] exceeds x − M (K−1 if none does).

Entry points:

``sample_fused_rows(u, doc, word, D, W_hat, k1_w, a1_w, q_prime_w,
  alpha=)`` — the main path's. The kernel gathers each token's rows
  itself by doc and word id, so no (N, K) row matrix is ever built, and
  reads the per-word stats the iteration already has (``word_stats``:
  ``k[:, 0]``, ``a[:, 0]``, ``q_prime``; ``word_stats_arrays`` makes them
  from Ŵ).
``sample_fused_tiled_rows(u, doc, word, tile_first, tile_size, D, W_hat,
  k1_w, a1_w, q_prime_w, win_words=, alpha=)`` — the tile-scheduled main
  path: token t lies in tile ``t // tile_size``, and its Ŵ row and stats
  are read through that tile's ``(win_words, K)`` word window, as the
  Pallas kernel reads it. Bitwise equal to ``sample_fused_rows`` for
  every tile whose word run fits the window (the caller sends only those).
``sample_fused(u, d_rows, w_rows, alpha=)`` and ``sample_fused_tiled(u,
  d_rows, w_hat, word_ids, first_word, alpha=, win_words=)`` — the
  reference's signatures on pre-gathered rows, kept as the parity entry
  points: they derive the stats from the rows with PyTorch and run the
  same kernels.

On the card the kernels (``csrc/sample_fused.cu``) are bound by bytes:
each token needs its two K-wide rows (at most N·K·8 B) plus 40 B of its
own and its word's. A warp draws a run of consecutive tokens and reloads
a row only when the doc or word changes, so the caller's token order
decides how often a row is read (T order shares words, doc-major order
docs). They are built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/nvcc.py``) and loaded with ``ctypes``.

A wrapper takes its plain twin only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fall back.
``sample_fused_rows.launches`` and ``sample_fused_tiled_rows.launches``
count the kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import fused_word_stats, sample_fused_stats_ref

__all__ = ["sample_fused", "sample_fused_rows", "sample_fused_rows_plain",
           "sample_fused_tiled", "sample_fused_tiled_rows",
           "sample_fused_tiled_rows_plain", "window_rows",
           "word_stats_arrays", "build"]

_PLAIN_TILE = 4096         # tokens per gathered tile in the plain twin
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library.

    Returns the loaded library and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel).
    """
    lib, log = nvcc.load("sample_fused")
    lib.sample_fused_launch.argtypes = [_P] * 12 + [
        ctypes.c_longlong, _I, _F, _P]
    lib.sample_fused_tiled_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 9 \
        + [ctypes.c_longlong, _I, _F, _P]
    for fn in (lib.sample_fused_launch, lib.sample_fused_tiled_launch):
        fn.restype = _I
    lib.sample_fused_error_string.argtypes = [_I]
    lib.sample_fused_error_string.restype = ctypes.c_char_p
    return lib, log


def word_stats_arrays(W_hat: torch.Tensor, *, alpha: float):
    """The per-word arrays the kernels take, from Ŵ with PyTorch: (K1
    int32, a1, Q') per row, contiguous. Equal to ``word_stats``' ``k[:,
    0]``, ``a[:, 0]`` and ``q_prime`` (the first maximal topic, its value,
    α·(ΣŴ − a1))."""
    return tuple(x.contiguous() for x in fused_word_stats(W_hat,
                                                          alpha=alpha))


def window_rows(word: torch.Tensor, tile_first: torch.Tensor,
                tile_size: int, win_words: int, n_words: int):
    """The row each token reads through its tile's word window:
    ``base + clip(word − base, 0, win − 1)`` with ``base =
    clip(tile_first[tile], 0, V − win)`` — the Pallas kernel's offset."""
    tile = torch.arange(word.shape[0], device=word.device) // tile_size
    base = torch.clamp(tile_first[tile], 0, n_words - win_words)
    return base + torch.clamp(word - base, 0, win_words - 1)


def sample_fused_rows_plain(u, doc, word, D, W_hat, k1_w, a1_w, q_prime_w,
                            *, alpha: float):
    """The kernel's plain-PyTorch twin, on any device: gather rows and
    word stats tile by tile (bounding live memory), then
    ``ref.sample_fused_stats_ref``."""
    n = u.shape[0]
    dev = u.device
    topic = torch.empty(n, dtype=torch.int32, device=dev)
    m, s, q = (torch.empty(n, dtype=torch.float32, device=dev)
               for _ in range(3))
    for lo in range(0, n, _PLAIN_TILE):
        hi = min(lo + _PLAIN_TILE, n)
        v = word[lo:hi].long()
        topic[lo:hi], m[lo:hi], s[lo:hi], q[lo:hi] = sample_fused_stats_ref(
            u[lo:hi], D[doc[lo:hi].long()], W_hat[v], k1_w[v], a1_w[v],
            q_prime_w[v], alpha=alpha)
    return topic, m, s, q


def _check(u, doc, word, D, W_hat, k1_w, a1_w, q_prime_w) -> None:
    n = u.shape[0]
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_fused: unsupported device {u.device}")
    for name, t, dtype, ndim in (("u", u, torch.float32, 1),
                                 ("doc", doc, torch.int32, 1),
                                 ("word", word, torch.int32, 1),
                                 ("D", D, torch.int32, 2),
                                 ("W_hat", W_hat, torch.float32, 2),
                                 ("k1_w", k1_w, torch.int32, 1),
                                 ("a1_w", a1_w, torch.float32, 1),
                                 ("q_prime_w", q_prime_w, torch.float32, 1)):
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"sample_fused: {name} must be a contiguous "
                             f"{ndim}-d {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"sample_fused: {name} is on {t.device}, u on "
                             f"{u.device}")
    if doc.shape[0] != n or word.shape[0] != n:
        raise ValueError("sample_fused: u, doc and word differ in length")
    if D.shape[1] != W_hat.shape[1] or D.shape[1] < 1:
        raise ValueError(f"sample_fused: D {tuple(D.shape)} and W_hat "
                         f"{tuple(W_hat.shape)} need one K >= 1")
    v_total = W_hat.shape[0]
    if any(x.shape[0] != v_total for x in (k1_w, a1_w, q_prime_w)):
        raise ValueError(f"sample_fused: the word stats need {v_total} rows "
                         "(one per row of W_hat)")
    if n:
        d_lo, d_hi, w_lo, w_hi, k_lo, k_hi = torch.stack(
            [doc.min(), doc.max(), word.min(), word.max(), k1_w.min(),
             k1_w.max()]).tolist()
        if d_lo < 0 or d_hi >= D.shape[0] or w_lo < 0 or w_hi >= v_total:
            raise ValueError("sample_fused: a doc or word id lies outside "
                             "D or W_hat")
        if k_lo < 0 or k_hi >= D.shape[1]:
            raise ValueError("sample_fused: a K1 lies outside [0, K)")


def sample_fused_rows(u: torch.Tensor, doc: torch.Tensor, word: torch.Tensor,
                      D: torch.Tensor, W_hat: torch.Tensor,
                      k1_w: torch.Tensor, a1_w: torch.Tensor,
                      q_prime_w: torch.Tensor, *, alpha: float):
    """Draw topics for N tokens whose rows are D[doc] and W_hat[word].

    Args: u (N,) f32 uniforms in [0, 1); doc, word (N,) int32; D (M, K)
    int32; W_hat (V, K) f32; k1_w (V,) int32, a1_w and q_prime_w (V,) f32
    the words' K1, a1 and Q'. Returns (topic int32, M, S', Q' f32), each
    (N,).
    """
    stats = (k1_w, a1_w, q_prime_w)
    _check(u, doc, word, D, W_hat, *stats)
    if u.device.type == "cpu":
        return sample_fused_rows_plain(u, doc, word, D, W_hat, *stats,
                                       alpha=alpha)
    out = _launch("sample_fused_launch", u, doc, word, (), D, W_hat, stats,
                  alpha)
    if u.shape[0]:
        sample_fused_rows.launches += 1
    return out


sample_fused_rows.launches = 0


def _launch(entry: str, u, doc, word, window: tuple, D, W_hat, stats,
            alpha):
    """Allocate the outputs and launch ``entry`` on the current stream;
    raise if the launch is refused."""
    lib, _ = build()
    n, k = u.shape[0], D.shape[1]
    topic = torch.empty(n, dtype=torch.int32, device=u.device)
    m, s, q = (torch.empty(n, dtype=torch.float32, device=u.device)
               for _ in range(3))
    if n == 0:
        return topic, m, s, q
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        code = getattr(lib, entry)(
            u.data_ptr(), doc.data_ptr(), word.data_ptr(), *window,
            D.data_ptr(), W_hat.data_ptr(), *(x.data_ptr() for x in stats),
            topic.data_ptr(), m.data_ptr(), s.data_ptr(), q.data_ptr(), n, k,
            float(alpha), stream)
    if code != 0:
        raise RuntimeError(f"{entry} failed at K={k}: "
                           + lib.sample_fused_error_string(code).decode())
    return topic, m, s, q


def _check_tiles(u, tile_first, tile_size, win_words, n_words) -> None:
    n_tiles = -(-u.shape[0] // tile_size) if tile_size >= 1 else -1
    if tile_first.dtype != torch.int32 or tile_first.dim() != 1 \
            or not tile_first.is_contiguous() \
            or tile_first.device != u.device:
        raise ValueError("sample_fused_tiled: tile_first must be a "
                         "contiguous 1-d int32 tensor beside u")
    if tile_size < 1 or tile_first.shape[0] < n_tiles:
        raise ValueError(f"sample_fused_tiled: {tile_first.shape[0]} tile "
                         f"starts for {u.shape[0]} tokens in tiles of "
                         f"{tile_size}")
    if not 1 <= win_words <= n_words:
        raise ValueError(f"sample_fused_tiled: win_words={win_words} "
                         f"outside [1, V={n_words}]")


def sample_fused_tiled_rows_plain(u, doc, word, tile_first, tile_size, D,
                                  W_hat, k1_w, a1_w, q_prime_w, *,
                                  win_words: int, alpha: float):
    """The tiled kernel's plain twin: the untiled twin on the rows read
    through each tile's window."""
    rows = window_rows(word.long(), tile_first.long(), tile_size,
                       win_words, W_hat.shape[0])
    return sample_fused_rows_plain(u, doc, rows, D, W_hat, k1_w, a1_w,
                                   q_prime_w, alpha=alpha)


def sample_fused_tiled_rows(u: torch.Tensor, doc: torch.Tensor,
                            word: torch.Tensor, tile_first: torch.Tensor,
                            tile_size: int, D: torch.Tensor,
                            W_hat: torch.Tensor, k1_w: torch.Tensor,
                            a1_w: torch.Tensor, q_prime_w: torch.Tensor, *,
                            win_words: int, alpha: float):
    """``sample_fused_rows`` with each token's Ŵ row and word stats read
    through its tile's word window.

    Token t lies in tile ``t // tile_size``; ``tile_first`` (n_tiles,)
    int32 holds each tile's first word. Returns (topic, M, S', Q').
    """
    stats = (k1_w, a1_w, q_prime_w)
    _check(u, doc, word, D, W_hat, *stats)
    _check_tiles(u, tile_first, tile_size, win_words, W_hat.shape[0])
    if u.device.type == "cpu":
        return sample_fused_tiled_rows_plain(
            u, doc, word, tile_first, tile_size, D, W_hat, *stats,
            win_words=win_words, alpha=alpha)
    window = (tile_first.data_ptr(), int(tile_size), int(win_words),
              W_hat.shape[0])
    out = _launch("sample_fused_tiled_launch", u, doc, word, window, D,
                  W_hat, stats, alpha)
    if u.shape[0]:
        sample_fused_tiled_rows.launches += 1
    return out


sample_fused_tiled_rows.launches = 0


def sample_fused(u: torch.Tensor, d_rows: torch.Tensor, w_rows: torch.Tensor,
                 *, alpha: float):
    """Sample topics from pre-gathered (D, Ŵ) rows (the reference's
    signature): the rows' own stats (``word_stats_arrays``) and the same
    kernel with doc = word = arange(N)."""
    n = d_rows.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=d_rows.device)
    return sample_fused_rows(u, ids, ids, d_rows, w_rows,
                             *word_stats_arrays(w_rows, alpha=alpha),
                             alpha=alpha)


def sample_fused_tiled(u: torch.Tensor, d_rows: torch.Tensor,
                       w_hat: torch.Tensor, word_ids: torch.Tensor,
                       first_word, *, alpha: float, win_words: int):
    """The reference's tiled signature: pre-gathered D rows, the full Ŵ,
    one tile of N tokens whose run starts at ``first_word``. The same
    kernel with doc = arange(N), one tile, and Ŵ's own word stats."""
    n = d_rows.shape[0]
    dev = d_rows.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.as_tensor(first_word, dtype=torch.int32).reshape(1).to(dev)
    return sample_fused_tiled_rows(
        u, ids, word_ids, first, max(n, 1), d_rows, w_hat,
        *word_stats_arrays(w_hat, alpha=alpha),
        win_words=min(int(win_words), w_hat.shape[0]), alpha=alpha)
