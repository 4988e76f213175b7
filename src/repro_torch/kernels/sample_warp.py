"""Warp MH sampling: CUDA kernels and their plain-PyTorch twins.

Replaces the TPU kernel ``sample_warp_tiled`` of
``src/repro/kernels/sample_warp.py`` (``pallas_call`` at line 164), which
per token tile builds the window's Vose alias tables, replays the word
proposals against them and runs the MH cycles. ``csrc/sample_warp.cu``
splits that in two kernels (its header says why), each with two entries:

``vose_tables(scaled)`` -> (prob, alias)
  The main path's table build: one warp builds each row's small and large
  queues (a stable partition of the slots by ``scaled < 1``) and runs the
  Vose pairing loop, one lane a row, once per table build over every row.
  Twin: ``core/mh.py`` ``run_vose`` on ``alias_queues``.
  ``alias_tables(weights)`` wraps it with q = w / Σw and scaled = q·K.
``vose_build(scaled, squeue, lqueue, n_small)`` -> (prob, alias)
  The same kernel body reading the queues instead (the reference's
  signature). Twin: ``mh.run_vose``.
``warp_chain_tokens(idx, topics, doc, word, u_doc, u_word, u_acc, D,
  W_hat, tables, index, alpha=, out=)``
  The main path's chain: one thread per token of ``idx``, reading the
  whole-corpus streams there, drawing the doc proposal through the doc
  index (``mh.doc_proposals``), the word proposal from the tables, and
  running the MH cycles; writes the topics and accepted counts at
  ``idx``. Twin: ``mh.doc_proposals`` then ``kernels/ref.py``
  ``warp_chain_ref`` on the gathered streams.
``warp_chain_tokens_tiled(idx, tile_first, tile_size, ..., win_words=)``
  The same with each token's rows read through its tile's word window, as
  the Pallas kernel reads them: bitwise equal to ``warp_chain_tokens`` for
  every tile whose word run fits the window (the caller sends only those).
``warp_chain_rows(s0, doc, word, t_doc, u_draw, u_acc, D, W_hat, tables,
  alpha=)`` and ``warp_chain_tiled_rows(...)``
  The same kernel body on compact streams with the doc proposals given
  (``t_doc``); returns (topics, accepted counts). ``sample_warp_tiled``,
  the reference's signature on pre-gathered D rows and one window, runs
  ``vose_build`` and ``warp_chain_rows``.

A wrapper takes its plain twin only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fall back. Each
launching wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import mh
from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import warp_chain_ref
from repro_torch.kernels.sample_fused import _check_tiles, window_rows

__all__ = ["vose_tables", "vose_tables_plain", "vose_build", "alias_tables",
           "check_doc_streams", "warp_chain_tokens",
           "warp_chain_tokens_plain", "warp_chain_tokens_tiled",
           "warp_chain_tokens_tiled_plain", "warp_chain_rows",
           "warp_chain_rows_plain", "warp_chain_tiled_rows",
           "warp_chain_tiled_rows_plain", "sample_warp_tiled", "build"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_ACC_MAX = 255        # the main path's accepted counts are u8, saturating


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library;
    returns it and the compiler's output."""
    lib, log = nvcc.load("sample_warp")
    lib.vose_tables_launch.argtypes = [_P] * 3 + [_L, _I, _P, _P]
    lib.vose_build_launch.argtypes = [_P] * 6 + [_L, _I, _P, _P]
    lib.vose_build_slab_warps.argtypes = [_L, _I]
    lib.vose_build_slab_warps.restype = _L
    tail = [_P] * 10 + [_L, _I, _I, _F, _P]
    lib.warp_chain_launch.argtypes = [_P] * 3 + tail
    lib.warp_chain_tiled_launch.argtypes = [_P] * 4 + [_I] * 3 + tail
    index = [_P] * 3 + [_I] * 3                   # start, length, perm, sizes
    tokens = [_P] * 9 + [_L, _L, _I, _I, _F, _F, _P]
    lib.warp_chain_tokens_launch.argtypes = [_P] * 5 + index + tokens
    lib.warp_chain_tokens_tiled_launch.argtypes = \
        [_P, _P, _I, _I] + [_P] * 4 + index + tokens
    for fn in (lib.vose_tables_launch, lib.vose_build_launch,
               lib.warp_chain_launch, lib.warp_chain_tiled_launch,
               lib.warp_chain_tokens_launch,
               lib.warp_chain_tokens_tiled_launch):
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

def _launch_vose(entry: str, scaled: torch.Tensor, queues: tuple):
    """One launch of the table build: ``entry`` builds (no ``queues``) or
    reads them. Past K = 29,056 the kernel works in global memory, on a
    scratch row a warp allocated here for the launch."""
    lib, _ = build()
    R, K = scaled.shape
    prob = torch.empty((R, K), dtype=torch.float32, device=scaled.device)
    alias = torch.empty((R, K), dtype=torch.int32, device=scaled.device)
    if R == 0 or K == 0:
        return prob, alias, False
    warps = lib.vose_build_slab_warps(R, K)
    slab = torch.empty((warps, K), dtype=torch.int32,
                       device=scaled.device) if warps else None
    with torch.cuda.device(scaled.device):
        stream = torch.cuda.current_stream(scaled.device).cuda_stream
        code = getattr(lib, entry)(
            scaled.data_ptr(), *(x.data_ptr() for x in queues),
            prob.data_ptr(), alias.data_ptr(), R, K,
            None if slab is None else slab.data_ptr(), stream)
    _raise_on(lib, entry, code)
    return prob, alias, True


def vose_tables_plain(scaled: torch.Tensor):
    """The main-path table build's plain twin: ``mh.run_vose`` on
    ``mh.alias_queues``."""
    return mh.run_vose(scaled, *mh.alias_queues(scaled))


def vose_tables(scaled: torch.Tensor):
    """Vose tables of every row of ``scaled`` = q·K (R, K) float32, the
    queues built in the kernel -> (prob (R, K) float32, alias (R, K)
    int32). Bitwise equal to ``vose_tables_plain``."""
    R, K = scaled.shape
    _check("vose_tables", (("scaled", scaled, torch.float32, (R, K)),),
           scaled.device)
    if scaled.device.type == "cpu":
        return vose_tables_plain(scaled)
    prob, alias, launched = _launch_vose("vose_tables_launch", scaled, ())
    vose_tables.launches += launched
    return prob, alias


vose_tables.launches = 0


def vose_build(scaled: torch.Tensor, squeue: torch.Tensor,
               lqueue: torch.Tensor, n_small: torch.Tensor):
    """Vose pairing from given queues -> (prob (R, K) float32, alias (R, K)
    int32).

    ``scaled`` = q·K (R, K) float32 and its queues as ``mh.alias_queues``
    gives them. Bitwise equal to ``mh.run_vose``: the kernel body of
    ``vose_tables``, reading the queues instead of building them.
    """
    R, K = scaled.shape
    _check("vose_build", (("scaled", scaled, torch.float32, (R, K)),
                          ("squeue", squeue, torch.int32, (R, K)),
                          ("lqueue", lqueue, torch.int32, (R, K)),
                          ("n_small", n_small, torch.int32, (R,))),
           scaled.device)
    if scaled.device.type == "cpu":
        return mh.run_vose(scaled, squeue, lqueue, n_small)
    prob, alias, launched = _launch_vose(
        "vose_build_launch", scaled, (squeue, lqueue, n_small))
    vose_build.launches += launched
    return prob, alias


vose_build.launches = 0


def alias_tables(weights: torch.Tensor) -> mh.AliasTables:
    """``mh.build_alias_tables`` with the queues and the pairing loop in
    the ``vose_tables`` kernel: q and scaled = q·K from one PyTorch op
    each, then one launch."""
    q, scaled = mh.proposal_weights(weights.float())
    prob, alias = vose_tables(scaled)
    return mh.AliasTables(prob=prob, alias=alias, q=q)


# -- the chain on compact streams, doc proposals given ---------------------

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


# -- the main path's chain -------------------------------------------------

def check_doc_streams(doc: torch.Tensor, word: torch.Tensor,
                      index: mh.DocIndex, *, n_docs: int,
                      n_words: int) -> None:
    """The range checks ``warp_chain_tokens`` leaves to its caller, made
    once per corpus: every doc id in [0, n_docs), word id in [0, n_words)
    and ``index.perm`` entry in [0, len(doc)), ``index`` of ``n_docs``
    docs and at least one slot. Raises ValueError. (The kernel also stops
    on such a value rather than read outside an array.)"""
    n_perm = index.perm.shape[0]
    if tuple(index.start.shape) != (n_docs,) \
            or tuple(index.length.shape) != (n_docs,) or n_perm < 1:
        raise ValueError(f"warp_chain: the doc index must cover {n_docs} "
                         "docs with at least one perm slot")
    lo_hi = [index.perm.min(), index.perm.max()]
    if doc.numel():
        lo_hi += [doc.min(), doc.max(), word.min(), word.max()]
    p_lo, p_hi, *ids = torch.stack(lo_hi).tolist()
    if p_lo < 0 or p_hi >= max(doc.shape[0], 1):
        raise ValueError("warp_chain: the doc index's perm points outside "
                         "the token stream")
    if ids and (ids[0] < 0 or ids[1] >= n_docs or ids[2] < 0
                or ids[3] >= n_words):
        raise ValueError("warp_chain: a doc or word id lies outside D or "
                         "W_hat")


def _check_tokens(name, idx, topics, doc, word, u_doc, u_word, u_acc, D,
                  W_hat, tables: mh.AliasTables, index: mh.DocIndex,
                  out) -> None:
    n, N = idx.shape[0], topics.shape[0]
    C = u_doc.shape[0] if u_doc.dim() == 3 else -1
    V, K = W_hat.shape
    M = D.shape[0]
    _check(name, (
        ("idx", idx, torch.int32, (n,)), ("topics", topics, torch.int32, (N,)),
        ("doc", doc, torch.int32, (N,)), ("word", word, torch.int32, (N,)),
        ("u_doc", u_doc, torch.float32, (C, 3, N)),
        ("u_word", u_word, torch.float32, (C, 2, N)),
        ("u_acc", u_acc, torch.float32, (C, 2, N)),
        ("D", D, torch.int32, (M, K)),
        ("W_hat", W_hat, torch.float32, (V, K)),
        ("q", tables.q, torch.float32, (V, K)),
        ("prob", tables.prob, torch.float32, (V, K)),
        ("alias", tables.alias, torch.int32, (V, K)),
        ("start", index.start, torch.int32, (M,)),
        ("length", index.length, torch.int32, (M,)),
        ("perm", index.perm, torch.int32, (index.perm.shape[0],)),
        ("out[0]", out[0], torch.int32, (N,)),
        ("out[1]", out[1], torch.uint8, (N,))), topics.device)
    if K < 1 or index.perm.shape[0] < 1:
        raise ValueError(f"{name}: K and the doc index's perm need >= 1 "
                         "entry")
    if out[0].untyped_storage().data_ptr() \
            == topics.untyped_storage().data_ptr():
        raise ValueError(f"{name}: out[0] shares memory with topics, which "
                         "the chain reads while it writes")


def _tokens_plain(idx, rows, topics, doc, u_doc, u_word, u_acc, D, W_hat,
                  tables, index, alpha, out):
    i = idx.long()
    d = doc[i]
    t_doc = mh.doc_proposals(u_doc[:, :, i], topics, d, index,
                             n_topics=W_hat.shape[1], alpha=alpha)
    s, n_acc = warp_chain_ref(topics[i], d, rows, t_doc, u_word[:, :, i],
                              u_acc[:, :, i], D, W_hat, tables.q,
                              tables.prob, tables.alias, alpha=alpha)
    out[0][i] = s
    out[1][i] = torch.clamp(n_acc, max=_ACC_MAX).to(torch.uint8)
    return out


def warp_chain_tokens_plain(idx, topics, doc, word, u_doc, u_word, u_acc, D,
                            W_hat, tables: mh.AliasTables,
                            index: mh.DocIndex, *, alpha: float, out):
    """The main-path chain's plain twin, on any device: ``mh.doc_proposals``
    and ``warp_chain_ref`` on the streams gathered at ``idx``, written at
    ``idx``."""
    return _tokens_plain(idx, word[idx.long()], topics, doc, u_doc, u_word,
                         u_acc, D, W_hat, tables, index, alpha, out)


def _launch_tokens(entry: str, window: tuple, idx, topics, doc, word, u_doc,
                   u_word, u_acc, D, W_hat, tables, index, alpha,
                   out) -> bool:
    lib, _ = build()
    n, N = idx.shape[0], topics.shape[0]
    V, K = W_hat.shape
    if n == 0:
        return False
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        code = getattr(lib, entry)(
            idx.data_ptr(), *window, topics.data_ptr(), doc.data_ptr(),
            word.data_ptr(), u_doc.data_ptr(), index.start.data_ptr(),
            index.length.data_ptr(), index.perm.data_ptr(),
            index.perm.shape[0], D.shape[0], V, u_word.data_ptr(),
            u_acc.data_ptr(), D.data_ptr(), W_hat.data_ptr(),
            tables.q.data_ptr(), tables.prob.data_ptr(),
            tables.alias.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            n, N, K, u_doc.shape[0], float(alpha), K * alpha, stream)
    _raise_on(lib, entry, code)
    return True


def warp_chain_tokens(idx: torch.Tensor, topics: torch.Tensor,
                      doc: torch.Tensor, word: torch.Tensor,
                      u_doc: torch.Tensor, u_word: torch.Tensor,
                      u_acc: torch.Tensor, D: torch.Tensor,
                      W_hat: torch.Tensor, tables: mh.AliasTables,
                      index: mh.DocIndex, *, alpha: float, out):
    """The MH chain of the tokens at ``idx`` of the whole-corpus streams,
    the doc proposals drawn in the kernel.

    Args: idx (n,) int32 stream positions; topics (the iteration-start
    topics), doc, word (N,) int32; u_doc (C, 3, N), u_word, u_acc (C, 2,
    N) float32; D (M, K) int32; W_hat (V, K) float32 live Ŵ; ``tables``
    over the (possibly stale) W̃; ``index`` the corpus's doc index (its
    ids checked once by ``check_doc_streams``). Writes ``out`` = (topics
    (N,) int32, accepted-proposal counts (N,) uint8, saturating at 255)
    at ``idx`` and returns it; ``out[0]`` must not share memory with
    ``topics``. On the card an id or topic out of range stops the launch
    (the next synchronisation raises) instead of reading past an array.
    """
    _check_tokens("warp_chain_tokens", idx, topics, doc, word, u_doc, u_word,
                  u_acc, D, W_hat, tables, index, out)
    if idx.device.type == "cpu":
        return warp_chain_tokens_plain(idx, topics, doc, word, u_doc, u_word,
                                       u_acc, D, W_hat, tables, index,
                                       alpha=alpha, out=out)
    warp_chain_tokens.launches += _launch_tokens(
        "warp_chain_tokens_launch", (), idx, topics, doc, word, u_doc,
        u_word, u_acc, D, W_hat, tables, index, alpha, out)
    return out


warp_chain_tokens.launches = 0


def warp_chain_tokens_tiled_plain(idx, tile_first, tile_size, topics, doc,
                                  word, u_doc, u_word, u_acc, D, W_hat,
                                  tables: mh.AliasTables, index: mh.DocIndex,
                                  *, win_words: int, alpha: float, out):
    """The tiled main-path chain's plain twin: the untiled twin on the rows
    read through each tile's window."""
    rows = window_rows(word[idx.long()].long(), tile_first.long(), tile_size,
                       win_words, W_hat.shape[0]).to(torch.int32)
    return _tokens_plain(idx, rows, topics, doc, u_doc, u_word, u_acc, D,
                         W_hat, tables, index, alpha, out)


def warp_chain_tokens_tiled(idx: torch.Tensor, tile_first: torch.Tensor,
                            tile_size: int, topics: torch.Tensor,
                            doc: torch.Tensor, word: torch.Tensor,
                            u_doc: torch.Tensor, u_word: torch.Tensor,
                            u_acc: torch.Tensor, D: torch.Tensor,
                            W_hat: torch.Tensor, tables: mh.AliasTables,
                            index: mh.DocIndex, *, win_words: int,
                            alpha: float, out):
    """``warp_chain_tokens`` with each token's rows read through its
    tile's word window: token i of ``idx`` lies in tile ``i //
    tile_size``, whose first word is ``tile_first[tile]`` ((n_tiles,)
    int32)."""
    _check_tokens("warp_chain_tokens_tiled", idx, topics, doc, word, u_doc,
                  u_word, u_acc, D, W_hat, tables, index, out)
    _check_tiles(idx, tile_first, tile_size, win_words, W_hat.shape[0])
    if idx.device.type == "cpu":
        return warp_chain_tokens_tiled_plain(
            idx, tile_first, tile_size, topics, doc, word, u_doc, u_word,
            u_acc, D, W_hat, tables, index, win_words=win_words, alpha=alpha,
            out=out)
    window = (tile_first.data_ptr(), int(tile_size), int(win_words))
    warp_chain_tokens_tiled.launches += _launch_tokens(
        "warp_chain_tokens_tiled_launch", window, idx, topics, doc, word,
        u_doc, u_word, u_acc, D, W_hat, tables, index, alpha, out)
    return out


warp_chain_tokens_tiled.launches = 0


# -- the reference's signature ----------------------------------------------

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
