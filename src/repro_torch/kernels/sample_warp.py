"""Warp MH sampling: CUDA kernels and their plain-PyTorch twins.

Replaces the TPU kernel ``sample_warp_tiled`` of
``src/repro/kernels/sample_warp.py`` (``pallas_call`` at line 164), which
per token tile builds the window's Vose alias tables, replays the word
proposals against them and runs the MH cycles. ``csrc/sample_warp.cu``
splits that in two kernels (its header says why):

``vose_build(scaled, squeue, lqueue, n_small)`` -> (prob, alias)
  The Vose pairing loop, one warp per row, run once per table build over
  every row. Twin: ``core/mh.py`` ``run_vose``. ``alias_tables(weights)``
  wraps it with the parts left in PyTorch: q = w / Σw, scaled = q·K and
  the sort-based queues (``mh.alias_queues``).
``warp_chain_rows(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat, tables,
  alpha=)`` -> (topics, accepted counts)
  The word-proposal draws and the MH cycles, one thread per token; the
  kernel gathers each token's D, Ŵ, q, prob and alias entries by id.
  Twin: ``kernels/ref.py`` ``warp_chain_ref``.
``warp_chain_tiled_rows(..., tile_first, tile_size, ..., win_words=)``
  The same with each token's rows read through its tile's word window, as
  the Pallas kernel reads them: bitwise equal to ``warp_chain_rows`` for
  every tile whose word run fits the window (the caller sends only those).
``sample_warp_tiled(...)``
  The reference's signature on pre-gathered D rows and one window, kept as
  the parity entry point; it runs the same kernels.

A wrapper takes its plain twin only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fall back.
``vose_build.launches``, ``warp_chain_rows.launches`` and
``warp_chain_tiled_rows.launches`` count the kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import mh
from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import warp_chain_ref
from repro_torch.kernels.sample_fused import _check_tiles, window_rows

__all__ = ["vose_build", "alias_tables", "warp_chain_rows",
           "warp_chain_rows_plain", "warp_chain_tiled_rows",
           "warp_chain_tiled_rows_plain", "sample_warp_tiled", "build"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library;
    returns it and the compiler's output."""
    lib, log = nvcc.load("sample_warp")
    lib.vose_build_launch.argtypes = [_P] * 6 + [_L, _I, _P, _P]
    lib.vose_build_slab_warps.argtypes = [_L, _I]
    lib.vose_build_slab_warps.restype = _L
    tail = [_P] * 10 + [_L, _I, _I, _F, _P]
    lib.warp_chain_launch.argtypes = [_P] * 3 + tail
    lib.warp_chain_tiled_launch.argtypes = [_P] * 4 + [_I] * 3 + tail
    for fn in (lib.vose_build_launch, lib.warp_chain_launch,
               lib.warp_chain_tiled_launch):
        fn.restype = _I
    lib.sample_warp_error_string.argtypes = [_I]
    lib.sample_warp_error_string.restype = ctypes.c_char_p
    return lib, log


def _raise_on(lib, entry: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.sample_warp_error_string(code).decode())


def _check(name: str, specs, device) -> None:
    """Each (label, tensor, dtype, shape) must be contiguous, of dtype and
    shape, on ``device``."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    for label, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                             f"tensor of shape {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, not "
                             f"{device}")


# -- the table build -----------------------------------------------------

def vose_build(scaled: torch.Tensor, squeue: torch.Tensor,
               lqueue: torch.Tensor, n_small: torch.Tensor):
    """Vose pairing -> (prob (R, K) float32, alias (R, K) int32).

    ``scaled`` = q·K (R, K) float32 and its queues from
    ``mh.alias_queues``. Bitwise equal to ``mh.run_vose``. While a row's
    five arrays fit a warp's shared memory (K <= 11,622) the kernel works
    there; past that it works in global memory, on a scratch slab of two
    rows a warp allocated here for the launch.
    """
    R, K = scaled.shape
    _check("vose_build", (("scaled", scaled, torch.float32, (R, K)),
                          ("squeue", squeue, torch.int32, (R, K)),
                          ("lqueue", lqueue, torch.int32, (R, K)),
                          ("n_small", n_small, torch.int32, (R,))),
           scaled.device)
    if scaled.device.type == "cpu":
        return mh.run_vose(scaled, squeue, lqueue, n_small)
    lib, _ = build()
    prob = torch.empty((R, K), dtype=torch.float32, device=scaled.device)
    alias = torch.empty((R, K), dtype=torch.int32, device=scaled.device)
    if R == 0 or K == 0:
        return prob, alias
    warps = lib.vose_build_slab_warps(R, K)
    slab = torch.empty((warps, 2, K), dtype=torch.int32,
                       device=scaled.device) if warps else None
    with torch.cuda.device(scaled.device):
        stream = torch.cuda.current_stream(scaled.device).cuda_stream
        code = lib.vose_build_launch(
            scaled.data_ptr(), squeue.data_ptr(), lqueue.data_ptr(),
            n_small.data_ptr(), prob.data_ptr(), alias.data_ptr(), R, K,
            None if slab is None else slab.data_ptr(), stream)
    _raise_on(lib, "vose_build_launch", code)
    vose_build.launches += 1
    return prob, alias


vose_build.launches = 0


def alias_tables(weights: torch.Tensor) -> mh.AliasTables:
    """``mh.build_alias_tables`` with the pairing loop on ``vose_build``:
    q and scaled = q·K from one PyTorch op each, the sort-based queues,
    then the kernel."""
    q, scaled = mh.proposal_weights(weights.float())
    squeue, lqueue, n_small = mh.alias_queues(scaled)
    prob, alias = vose_build(scaled, squeue, lqueue, n_small)
    return mh.AliasTables(prob=prob, alias=alias, q=q)


# -- the chain -----------------------------------------------------------

def _check_chain(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat,
                 tables: mh.AliasTables) -> None:
    n = s0.shape[0]
    C = t_doc.shape[0] if t_doc.dim() == 2 else -1
    V, K = W_hat.shape
    _check("warp_chain", (
        ("s0", s0, torch.int32, (n,)), ("doc", doc, torch.int32, (n,)),
        ("word", word, torch.int32, (n,)),
        ("t_doc", t_doc, torch.int32, (C, n)),
        ("u_draw", u_draw, torch.float32, (C, 2, n)),
        ("u_acc", u_acc, torch.float32, (C, 2, n)),
        ("D", D, torch.int32, (D.shape[0], K)),
        ("W_hat", W_hat, torch.float32, (V, K)),
        ("q", tables.q, torch.float32, (V, K)),
        ("prob", tables.prob, torch.float32, (V, K)),
        ("alias", tables.alias, torch.int32, (V, K))), s0.device)
    if K < 1:
        raise ValueError("warp_chain: K must be >= 1")
    if n:
        lo_hi = torch.stack([doc.min(), doc.max(), word.min(), word.max(),
                             s0.min(), s0.max()]
                            + ([t_doc.min(), t_doc.max()] if C else []))
        d_lo, d_hi, w_lo, w_hi, s_lo, s_hi, *t = lo_hi.tolist()
        if d_lo < 0 or d_hi >= D.shape[0] or w_lo < 0 or w_hi >= V:
            raise ValueError("warp_chain: a doc or word id lies outside D "
                             "or W_hat")
        if s_lo < 0 or s_hi >= K or (t and (t[0] < 0 or t[1] >= K)):
            raise ValueError(f"warp_chain: a topic lies outside [0, {K})")


def warp_chain_rows_plain(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat,
                          tables: mh.AliasTables, *, alpha: float):
    """The chain kernel's plain twin, on any device."""
    return warp_chain_ref(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat,
                          tables.q, tables.prob, tables.alias, alpha=alpha)


def _launch_chain(entry: str, s0, doc, word, window: tuple, t_doc, u_draw,
                  u_acc, D, W_hat, tables, alpha):
    lib, _ = build()
    n, K = s0.shape[0], W_hat.shape[1]
    s_out = torch.empty(n, dtype=torch.int32, device=s0.device)
    acc = torch.empty(n, dtype=torch.int32, device=s0.device)
    if n == 0:
        return s_out, acc
    with torch.cuda.device(s0.device):
        stream = torch.cuda.current_stream(s0.device).cuda_stream
        code = getattr(lib, entry)(
            s0.data_ptr(), doc.data_ptr(), word.data_ptr(), *window,
            t_doc.data_ptr(), u_draw.data_ptr(), u_acc.data_ptr(),
            D.data_ptr(), W_hat.data_ptr(), tables.q.data_ptr(),
            tables.prob.data_ptr(), tables.alias.data_ptr(),
            s_out.data_ptr(), acc.data_ptr(), n, K, t_doc.shape[0],
            float(alpha), stream)
    _raise_on(lib, entry, code)
    return s_out, acc


def warp_chain_rows(s0: torch.Tensor, doc: torch.Tensor, word: torch.Tensor,
                    t_doc: torch.Tensor, u_draw: torch.Tensor,
                    u_acc: torch.Tensor, D: torch.Tensor,
                    W_hat: torch.Tensor, tables: mh.AliasTables, *,
                    alpha: float):
    """The MH chain for N tokens whose rows are D[doc] and Ŵ/q/prob/alias
    [word].

    Args: s0, doc, word (N,) int32; t_doc (C, N) int32 doc proposals;
    u_draw, u_acc (C, 2, N) float32; D (M, K) int32; W_hat (V, K) float32
    live Ŵ; ``tables`` over the (possibly stale) W̃. Returns (topics,
    accepted-proposal counts), both (N,) int32.
    """
    _check_chain(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat, tables)
    if s0.device.type == "cpu":
        return warp_chain_rows_plain(s0, doc, word, t_doc, u_draw, u_acc, D,
                                     W_hat, tables, alpha=alpha)
    out = _launch_chain("warp_chain_launch", s0, doc, word, (), t_doc,
                        u_draw, u_acc, D, W_hat, tables, alpha)
    if s0.shape[0]:
        warp_chain_rows.launches += 1
    return out


warp_chain_rows.launches = 0


def warp_chain_tiled_rows_plain(s0, doc, word, tile_first, tile_size, t_doc,
                                u_draw, u_acc, D, W_hat,
                                tables: mh.AliasTables, *, win_words: int,
                                alpha: float):
    """The tiled chain's plain twin: the untiled twin on the rows read
    through each tile's window."""
    rows = window_rows(word.long(), tile_first.long(), tile_size, win_words,
                       W_hat.shape[0]).to(torch.int32)
    return warp_chain_rows_plain(s0, doc, rows, t_doc, u_draw, u_acc, D,
                                 W_hat, tables, alpha=alpha)


def warp_chain_tiled_rows(s0: torch.Tensor, doc: torch.Tensor,
                          word: torch.Tensor, tile_first: torch.Tensor,
                          tile_size: int, t_doc: torch.Tensor,
                          u_draw: torch.Tensor, u_acc: torch.Tensor,
                          D: torch.Tensor, W_hat: torch.Tensor,
                          tables: mh.AliasTables, *, win_words: int,
                          alpha: float):
    """``warp_chain_rows`` with each token's rows read through its tile's
    word window: token t lies in tile ``t // tile_size``, whose first word
    is ``tile_first[tile]`` ((n_tiles,) int32)."""
    _check_chain(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat, tables)
    _check_tiles(s0, tile_first, tile_size, win_words, W_hat.shape[0])
    if s0.device.type == "cpu":
        return warp_chain_tiled_rows_plain(
            s0, doc, word, tile_first, tile_size, t_doc, u_draw, u_acc, D,
            W_hat, tables, win_words=win_words, alpha=alpha)
    window = (tile_first.data_ptr(), int(tile_size), int(win_words),
              W_hat.shape[0])
    out = _launch_chain("warp_chain_tiled_launch", s0, doc, word, window,
                        t_doc, u_draw, u_acc, D, W_hat, tables, alpha)
    if s0.shape[0]:
        warp_chain_tiled_rows.launches += 1
    return out


warp_chain_tiled_rows.launches = 0


def sample_warp_tiled(s0, d_rows, t_doc, u_draw, u_acc, w_hat, w_til,
                      squeue, lqueue, n_small, word_ids, first_word, *,
                      alpha: float, win_words: int):
    """The reference's signature: the MH chain for a chunk of N tokens
    against one word-run window starting at ``first_word``.

    ``d_rows`` (N, K) int32 are the tokens' pre-gathered D rows; ``w_hat``
    and ``w_til`` (V, K) the live Ŵ and the W̃ the tables are built from;
    ``squeue``/``lqueue``/``n_small`` its Vose queues (``mh.alias_queues``
    of the scaled rows). As in the Pallas kernel, the window's tables are
    built from its rows of W̃ and every token reads its rows at
    ``clip(word − first, 0, win − 1)`` of the window. Runs ``vose_build``
    on the window and ``warp_chain_rows`` on the window's rows. Returns
    (topics, accepted counts), both (N,) int32.
    """
    n, K = d_rows.shape
    V = w_hat.shape[0]
    win = int(min(int(win_words), V))
    first = min(max(int(first_word), 0), V - win)
    sl = slice(first, first + win)
    q, scaled = mh.proposal_weights(w_til[sl].float())
    prob, alias = vose_build(scaled.contiguous(), squeue[sl].contiguous(),
                             lqueue[sl].contiguous(),
                             n_small[sl].contiguous())
    tables = mh.AliasTables(prob=prob, alias=alias, q=q)
    local = torch.clamp(word_ids.long() - first, 0, win - 1).to(torch.int32)
    ids = torch.arange(n, dtype=torch.int32, device=d_rows.device)
    return warp_chain_rows(s0, ids, local, t_doc, u_draw, u_acc, d_rows,
                           w_hat[sl].contiguous(), tables, alpha=alpha)
