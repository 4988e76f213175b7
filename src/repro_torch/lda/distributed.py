"""Multi-GPU EZLDA (paper §V-B) and the topic-axis split, on
``torch.distributed``, and the word-sharded parameter server.

Port of ``src/repro/lda/distributed.py``. The replicated trainer
(``w_sync="replicate"``, ``DistLDATrainer``): the reference runs one SPMD
program under ``shard_map`` over a device mesh; the port runs one process
per rank, as ``torchrun`` starts them, over a
``runtime/sharding.py::ProcessMesh``:

  * documents -> chunks (``chunk_documents``, greedy token-balanced), or
    under ``balance="tiles"`` tokens -> shards through word runs
    (``core/balance.py::assign_token_shards``, dissecting any word past
    the threshold). Each (pod, data) rank holds one chunk: its tokens,
    their D rows and a replica of W. ``shard_corpus`` builds the same
    arrays as the reference's, bitwise.
  * each iteration, a rank samples its tokens against the
    iteration-start counts through the port's own resident sampler body,
    ``FusedPipeline._sample`` (the skip test, the compaction, and
    ``sample_fused(_tiled)`` / ``sample_sparse`` on the card), scatters
    its ±1 moves into its D and into a zero-filled dW, and one all-reduce
    of dW over the data axes rebuilds every replica of W: the paper's
    sum-and-broadcast. Documents dissected across shards (tiles) keep a
    full replica of their D row on every holder, glued by the same
    all-reduce over the shared-row list. The hybrid format densifies the
    rank's packed D rows and the replicated HybridW, samples, scatters and
    repacks, as the single-device hybrid pipeline does.
  * beyond the paper, with a ``model`` axis > 1 the topic axis of D and W
    is block-partitioned and the reference's two-level inverse CDF
    (``_word_phase`` and ``_token_sweep``: local top-(g+1), all-gather
    over ``model``, global re-top; a masked D lookup summed over
    ``model``; one claim per token) runs in plain PyTorch, as the
    reference wrote it in plain JAX, in chunks of tokens (results are per
    token, so chunking changes no bit). Dense format only.

Randomness differs from the reference by design: every token's uniform is
the single-device draw, ``draw_uniforms(seed, iteration, n_padded)`` over
the single engine's padded token order (``pad_corpus`` to
``tile_size``), read at the token's ``global_pos``, and the initial topics
are stream 0 over the same order. A draw reads only its own u and rows,
and every rank samples against the iteration-start counts, as the fused
iteration does, so with a model axis of 1 a distributed run is bitwise
the single-device run: topics, D, W and every LLPT, for any number of
data shards, dense or hybrid, with or without tiles. Branch statistics
are the reference's masked means over the real tokens, summed across
ranks as exact integer counts; the single path averages over its padded
slots, so the two agree to within the pad fraction, not bitwise.

Counts at init and restore are built on the rank's device: the rank's D
and W by the ``histogram`` kernel (any-order route), one all-reduce of W
over the data axes, and under tiles one of the shared rows' D. They are
exact integers, equal to the reference's host ``np.add.at`` build.

Checkpoints store topics in global token order (``host_payload``:
``topics_global``, the key data and the iteration), so a payload restores
on any mesh, in the single-device engine, and in the reference's engine.

Streamed residency (``corpus_residency="streamed"``): each rank keeps its
tokens on the host in ``n_sub`` equal sub-shards (the reference's
``_DistStream``) and an iteration becomes an epoch over them, each through
the same sweep against the epoch-start counts, its moves accumulated and
landed by the resident iteration's own all-reduces at the epoch close:
bitwise the resident run on every mesh.

The parameter server (``w_sync="ps"``, ``PSDistTrainer``): W lives only
in ``lda/ps.py``'s host-side owner shards; the workers of the grid run in
one process, one after another on the engine's device, each sweeping its
sub-shards against pulled pages of W and pushing the pages' deltas. At
``staleness=0`` it is bitwise the single-device run. Where the reference
runs the workers on its mesh's first device, the port needs no process
group at all.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.ps_payload import (pack_ps_payload,
                                               unpack_ps_payload)
from repro_torch.core import balance as balance_mod
from repro_torch.core import esca, sparse, three_branch
from repro_torch.core import llpt as llpt_mod
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels.ref import histogram_ref
from repro_torch.lda import invariants
from repro_torch.lda import ps as ps_mod
from repro_torch.lda.convert import key_data
from repro_torch.lda.corpus import Corpus, chunk_documents, pad_corpus
from repro_torch.lda.model import LDAConfig, uniforms_generator
from repro_torch.runtime import chaos
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.sharding import ProcessMesh, batch_axes, \
    mesh_axis_size
from repro_torch.train.lda_step import (PAGE_ROWS_FLOOR, FusedPipeline,
                                        HybridFusedPipeline, _Prefetcher,
                                        _read_back, _Staged, draw_uniforms,
                                        repack_counts, resolve_residency,
                                        resolves_to_disk,
                                        scatter_changed_deltas)

__all__ = ["ShardedCorpus", "shard_corpus", "DistLDAState",
           "DistHybridState", "DistStreamState", "DistLDATrainer",
           "PSStreamState", "PSDistTrainer"]

# Bytes of one (tokens, K_loc) float32 matrix of the topic-split sweep; the
# sweep holds a few such matrices per chunk of tokens.
SWEEP_CHUNK_BYTES = 1 << 27


# ---------------------------------------------------------------------------
# host-side partitioning (the paper's chunking, §IV-A/§V-B)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedCorpus:
    """Chunked corpus, padded to uniform per-shard length.

    Arrays carry a leading shard axis S = n_data_shards; doc ids are LOCAL
    row indices into the shard's D block (plus a global doc map for eval).
    """
    word_ids: np.ndarray      # (S, N_loc) int32 — word-sorted within shard
    doc_ids: np.ndarray       # (S, N_loc) int32 — local doc rows
    mask: np.ndarray          # (S, N_loc) int32
    doc_map: np.ndarray       # (S, M_loc) int64 — local row → global doc id
    docs_per_shard: np.ndarray  # (S,) int64
    global_pos: np.ndarray    # (S, N_loc) int64 — slot → global token index
                              # (pads point at token 0 with mask 0); makes
                              # checkpoints shard-layout independent (elastic)
    n_words: int
    m_local: int              # D rows per shard (padded)
    n_shards: int
    # balance="tiles" extras (None under document chunking): docs split
    # across shards by token-level assignment get REPLICATED D rows, glued
    # by a per-iteration delta all-reduce over a global shared-doc list.
    owns: np.ndarray | None = None         # (S, M_loc) int32 — 1 iff this
                                           # shard is the doc's gather owner
    shared_slot: np.ndarray | None = None  # (S, N_loc) int32 — token's slot
                                           # in the shared-doc list, or
                                           # n_shared (sentinel)
    shared_rows: np.ndarray | None = None  # (S, n_shared) int32 — shared doc
                                           # j's local row, or M_loc sentinel


def shard_corpus(corpus: Corpus, n_shards: int,
                 pad_multiple: int = 1024, balance: str = "none",
                 dissect_threshold: int | None = None) -> ShardedCorpus:
    """The reference's ``shard_corpus``, bitwise. A shard's documents and
    their local rows come from one presence table over the doc ids (the
    reference's ``np.unique`` and ``np.searchsorted`` give the same
    arrays in O(N log N))."""
    if balance == "tiles":
        tok_chunk, _loads = balance_mod.assign_token_shards(
            corpus, n_shards, dissect_threshold)
    else:
        assign = chunk_documents(corpus, n_shards)        # (M,) chunk per doc
        tok_chunk = assign[corpus.doc_ids]                # (N,)
    n_loc, m_loc = 1, 1
    per_shard: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    doc_maps = []
    local_of = np.empty(corpus.n_docs, np.int64)
    for s in range(n_shards):
        sel = np.nonzero(tok_chunk == s)[0]
        w = corpus.word_ids[sel]
        d = corpus.doc_ids[sel]
        present = np.zeros(corpus.n_docs, bool)
        present[d] = True
        docs = np.flatnonzero(present)                    # == np.unique(d)
        local_of[docs] = np.arange(docs.shape[0])
        local = local_of[d]                               # == searchsorted
        order = np.argsort(w, kind="stable")              # keep word-sorted T
        per_shard.append((w[order], local[order].astype(np.int32),
                          sel[order]))
        doc_maps.append(docs)
        n_loc = max(n_loc, len(w))
        m_loc = max(m_loc, len(docs))
    n_loc = -(-n_loc // pad_multiple) * pad_multiple
    W = np.zeros((n_shards, n_loc), np.int32)
    Dv = np.zeros((n_shards, n_loc), np.int32)
    Mk = np.zeros((n_shards, n_loc), np.int32)
    DM = np.zeros((n_shards, m_loc), np.int64)
    GP = np.zeros((n_shards, n_loc), np.int64)
    nd = np.zeros(n_shards, np.int64)
    for s, (w, d, gp) in enumerate(per_shard):
        W[s, :len(w)] = w
        W[s, len(w):] = corpus.n_words - 1                # keep sorted
        Dv[s, :len(d)] = d
        Mk[s, :len(w)] = 1
        DM[s, :len(doc_maps[s])] = doc_maps[s]
        GP[s, :len(gp)] = gp
        nd[s] = len(doc_maps[s])
    sc = ShardedCorpus(word_ids=W, doc_ids=Dv, mask=Mk, doc_map=DM,
                       docs_per_shard=nd, global_pos=GP,
                       n_words=corpus.n_words,
                       m_local=m_loc, n_shards=n_shards)
    if balance != "tiles":
        return sc

    # -- shared-doc bookkeeping (dissected documents) ----------------------
    # owner = lowest shard holding the doc: gathers count each row once
    owner = np.full(corpus.n_docs, -1, np.int64)
    for s in range(n_shards):
        fresh = doc_maps[s][owner[doc_maps[s]] < 0]
        owner[fresh] = s
    occ = np.bincount(np.concatenate(doc_maps) if doc_maps else
                      np.zeros(0, np.int64), minlength=corpus.n_docs)
    shared_global = np.nonzero(occ > 1)[0]                # global doc ids
    n_shared = max(len(shared_global), 1)                 # keep shapes >0
    slot_of_doc = np.full(corpus.n_docs, n_shared, np.int64)
    slot_of_doc[shared_global] = np.arange(len(shared_global))
    owns = np.zeros((n_shards, m_loc), np.int32)
    SS = np.full((n_shards, n_loc), n_shared, np.int32)
    SR = np.full((n_shards, n_shared), m_loc, np.int32)
    for s in range(n_shards):
        docs = doc_maps[s]
        owns[s, :len(docs)] = (owner[docs] == s)
        # token → shared slot, through the SAME global-position ordering
        # the token arrays above were built from
        gp = per_shard[s][2]
        SS[s, :len(gp)] = slot_of_doc[corpus.doc_ids[gp]]
        # shared doc j → local row on this shard (or the M_loc sentinel)
        if len(shared_global) and len(docs):
            pos = np.searchsorted(docs, shared_global)
            here = (pos < len(docs)) & (docs[np.minimum(pos, len(docs) - 1)]
                                        == shared_global)
            SR[s, :len(shared_global)] = np.where(here, pos, m_loc)
    return dataclasses.replace(sc, owns=owns, shared_slot=SS,
                               shared_rows=SR)


# ---------------------------------------------------------------------------
# state (one rank's tensors)
# ---------------------------------------------------------------------------

class DistLDAState(NamedTuple):
    """One rank's dense state: its token slots' topics, its D rows (its
    topic block of them with a model axis > 1), its replica of W (its
    topic block) and that block's column sum. The fields of
    ``train/lda_step.py::FusedState``."""
    topics: torch.Tensor   # (N_loc,) int32
    D: torch.Tensor        # (M_loc, K_loc) int32
    W: torch.Tensor        # (V, K_loc) int32, replicated over data
    colsum: torch.Tensor   # (K_loc,) int32 == W.sum(dim=0)
    iteration: int


class DistHybridState(NamedTuple):
    """One rank's hybrid state (model axis 1): packed D rows of its
    documents and the replicated HybridW, the fields of
    ``lda.model.SparseLDAState``. ``overflow`` is this rank's count of
    nonzeros a repack could not place: 0 by the capacity bound."""
    topics: torch.Tensor               # (N_loc,) int32
    D: torch.Tensor                    # (M_loc, L_d) int32 packed
    W_head: torch.Tensor               # (V_dense, K) int32, replicated
    W_tail: tuple[torch.Tensor, ...]   # packed tail buckets, replicated
    colsum: torch.Tensor               # (K,) int32
    overflow: torch.Tensor             # () int32
    iteration: int


class _Moves(NamedTuple):
    """The real tokens whose topic changed, with their old and new topic."""
    idx: torch.Tensor
    old: torch.Tensor
    new: torch.Tensor


# ---------------------------------------------------------------------------
# the topic-split sweep (model axis > 1): the reference's plain-JAX stages
# ---------------------------------------------------------------------------

def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, ties to the
    lower index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def _word_phase(W: torch.Tensor, colsum: torch.Tensor, mesh, *,
                beta: float, alpha: float, n_words: int, g: int, kb0: int,
                k_local: int):
    """Per-word quantities of an iteration over this rank's topic block:
    Ŵ, the global top-(g+1) values and topic ids (a local top-(g+1),
    all-gathered over ``model``, re-topped), and Q' from ΣŴ summed over
    ``model``. Returns (W_hat, g_vals, g_idx, q_prime)."""
    W_hat = esca.compute_w_hat_from_colsum(W, colsum, beta, n_words=n_words)
    loc_vals, loc_idx = _top(W_hat, min(g + 1, k_local))
    loc_idx = loc_idx.to(torch.int32) + kb0
    all_vals = mesh.all_gather(loc_vals, "model")         # (Pm, V, g+1)
    all_idx = mesh.all_gather(loc_idx, "model")
    V = W.shape[0]
    cat_vals = all_vals.movedim(0, 1).reshape(V, -1)
    cat_idx = all_idx.movedim(0, 1).reshape(V, -1)
    g_vals, g_pos = _top(cat_vals, g + 1)                 # (V, g+1) global
    g_idx = torch.gather(cat_idx, 1, g_pos)
    wsum = mesh.psum(three_branch.row_sum(W_hat), "model")
    q_prime = alpha * (wsum - g_vals[:, 0])               # (V,)
    return W_hat, g_vals, g_idx, q_prime


def _token_sweep(u, word_ids, doc_ids, d_tok, len_tot, W_hat, g_vals,
                 g_idx, q_prime_w, mesh, *, alpha: float, g: int, kb0: int,
                 k_local: int):
    """The skip test and the two-level inverse CDF for one chunk of
    tokens, ``d_tok`` their (n, K_loc) D rows of this rank's block.
    Returns (new_topics, skip, in_m, k1); every rank of a model slice
    returns the same values."""
    w = word_ids.long()
    a = g_vals[w]                                         # (n, g+1)
    ktop = g_idx[w][:, :g]                                # (n, g)
    rel = ktop - kb0
    in_blk = (rel >= 0) & (rel < k_local)
    b_loc = torch.where(
        in_blk, torch.gather(d_tok, 1, rel.clamp(0, k_local - 1).long()),
        0).to(torch.float32)
    b = mesh.psum(b_loc, "model")                         # (n, g)
    len_d = len_tot[doc_ids.long()]
    m_mass = a[:, 0] * (b[:, 0] + alpha)                  # Eq 8
    head = (a[:, 1:g] * b[:, 1:g]).sum(dim=-1)
    s_est = head + a[:, g] * (len_d - b.sum(dim=-1))
    skip = u * (m_mass + s_est + q_prime_w[w]) < m_mass
    k1 = ktop[:, 0]

    # phase 2: the two-level inverse CDF over the model slice
    w_rows = W_hat[w]                                     # (n, K_loc)
    k_global = kb0 + torch.arange(k_local, device=u.device)
    mass = torch.where(k_global[None, :] == k1[:, None],
                       torch.zeros((), device=u.device),
                       (d_tok.to(torch.float32) + alpha) * w_rows)
    del w_rows
    l_mine = mass.sum(dim=1)                              # (n,) local mass
    l_all = mesh.all_gather(l_mine, "model")              # (Pm, n)
    my = mesh.axis_index("model")
    pm = l_all.shape[0]
    before = torch.arange(pm, device=u.device)[:, None] < my
    cum_before = torch.where(before, l_all, 0.0).sum(dim=0)
    total = m_mass + l_all.sum(dim=0)
    x = u * total
    tgt = x - m_mass - cum_before                         # local CDF target
    hit = mass.cumsum(dim=1) > tgt[:, None]
    del mass
    found = hit.any(dim=1) & (tgt >= 0) & (x >= m_mass) & (tgt < l_mine)
    pick = kb0 + hit.to(torch.int8).argmax(dim=1).to(torch.int32)
    votes = mesh.psum(torch.stack([found.to(torch.int32),
                                   torch.where(found, pick, 0)]), "model")
    claimed, topic_win = votes[0], votes[1]
    # fp edge: zero or several claims fall back to K1 (measure zero)
    topic_exact = torch.where(claimed == 1, topic_win, k1)
    in_m = x < m_mass
    new_topics = torch.where(skip | in_m, k1, topic_exact).to(torch.int32)
    return new_topics, skip, in_m, k1


# ---------------------------------------------------------------------------
# streamed residency: this rank's token sub-shards
# ---------------------------------------------------------------------------

# The LLPT of a parameter-server state is folded over the single engine's
# padded token order in about this many chunks (whole tiles each), so the
# token list never lies on the device whole; a replicated rank evaluates
# its own slots in about as many pieces.
EVAL_CHUNKS = 8


def _extend_cols(arr: np.ndarray, total: int, fill) -> np.ndarray:
    """The reference's ``_extend_cols``: ``arr`` (S, n) widened to (S,
    total) with ``fill`` in the new columns."""
    out = np.full((arr.shape[0], total), fill, arr.dtype)
    out[:, :arr.shape[1]] = arr
    return out


@dataclasses.dataclass(frozen=True)
class _DistStream:
    """This rank's token slice tiled into ``n_sub`` equal sub-shards of
    ``sub_len`` slots: the reference's ``_DistStream`` row of this rank
    (the extension slots carry mask 0 and the largest word id, keeping
    every sub-shard word-sorted; their global position is token 0's)."""
    n_sub: int
    sub_len: int
    n_loc: int                 # the resident per-rank length
    word_ids: np.ndarray       # (n_sub·sub_len,) int32
    doc_ids: np.ndarray        # (n_sub·sub_len,) int32
    mask: np.ndarray           # (n_sub·sub_len,) int32
    global_pos: np.ndarray     # (n_sub·sub_len,) int64
    shared_slot: np.ndarray | None

    def cols(self, r: int) -> slice:
        return slice(r * self.sub_len, (r + 1) * self.sub_len)


def _build_stream(sc: ShardedCorpus, shard: int, n_sub: int,
                  pad_word: int) -> _DistStream:
    n_loc = int(sc.word_ids.shape[1])
    L = -(-n_loc // n_sub)
    total = n_sub * L

    def ext(a, fill):
        return _extend_cols(a[shard][None], total, fill)[0]

    return _DistStream(
        n_sub=n_sub, sub_len=L, n_loc=n_loc,
        word_ids=ext(sc.word_ids, pad_word), doc_ids=ext(sc.doc_ids, 0),
        mask=ext(sc.mask, 0), global_pos=ext(sc.global_pos, 0),
        shared_slot=None if sc.shared_slot is None else ext(
            sc.shared_slot, int(sc.shared_rows.shape[1])))


@dataclasses.dataclass
class _DistEpochCarry:
    """An open epoch of the streamed trainer: the iteration-start dense
    counts and the quantities derived from them (fixed for the epoch),
    the epoch's uniforms staged on the host, the accumulated D delta (the
    delta buffer ``DistLDATrainer._delta`` holds dW, Δcolsum and the
    shared rows' ΔD), the branch counts, survivors and tile spans, and
    the sampled sub-shards' topic readbacks not yet landed on the host
    (kept here so that a fault between sub-shards loses none of them) and,
    for an epoch opened by ``run_shards``, the epoch-start topics of the
    sub-shards already landed (``start``: what a mid-epoch checkpoint
    restores from)."""
    D: torch.Tensor
    W: torch.Tensor
    derived: tuple
    u_host: torch.Tensor
    dD: torch.Tensor
    counts: torch.Tensor
    n_surv: int = 0
    span: int = 0
    pending: list = dataclasses.field(default_factory=list)
    start: dict | None = None


@dataclasses.dataclass
class DistStreamState:
    """One rank's streamed state (``corpus_residency="streamed"``).

    The rank's token topics live on the host, ``(n_sub·sub_len,)`` in its
    sub-shard layout, and stream through the card a sub-shard at a time;
    the counts stay on the card: ``(D, W, colsum)`` dense (this rank's
    topic block with a model axis > 1), ``(D packed, W head, W tail,
    colsum, overflow)`` hybrid. ``cursor`` counts the sub-shards of the
    open epoch already sampled (0 between epochs)."""
    host_topics: np.ndarray
    counts: tuple
    iteration: int
    cursor: int = 0
    epoch: _DistEpochCarry | None = None

    @property
    def topics(self) -> np.ndarray:
        return self.host_topics


def _folded_llpt(arrays, D: torch.Tensor, W: torch.Tensor, cfg: LDAConfig,
                 device) -> float:
    """LLPT (Eq 5) of dense counts over the single engine's padded token
    order ``arrays`` = (word, doc, mask) tensors on the device or in
    pinned host memory, folded in chunks of whole tiles: every tile is the
    resident call's, so the result is bitwise ``llpt_mod.llpt`` over the
    whole arrays."""
    word, doc, mask = arrays
    n, tile = word.shape[0], cfg.tile_size
    step = tile * max(1, -(-n // (EVAL_CHUNKS * tile)))
    colsum = W.sum(dim=0, dtype=torch.float32)
    up = lambda t: t.to(device, non_blocking=True)  # noqa: E731
    parts = [llpt_mod.token_ll(up(word[lo:lo + step]), up(doc[lo:lo + step]),
                               D, W, colsum, alpha=cfg.alpha_,
                               beta=cfg.beta, n_words=W.shape[0],
                               tile_size=tile)
             for lo in range(0, n, step)]
    return float(llpt_mod.reduce_ll(torch.cat(parts), up(mask)))


def _pinned(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor the card copies at full rate and
    asynchronously (pinned when the device is a card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def _padded_order(corpus: Corpus, tile_size: int) -> tuple:
    """The single engine's padded token order as host (word, doc, mask)
    arrays: what the LLPT runs over."""
    padded, mask = pad_corpus(corpus, tile_size)
    return padded.word_ids, padded.doc_ids, mask


def _branch_counts(mask, skip, in_m, new_topics, topics, k1):
    """The real tokens' branch counts, (5,) int64: real, skipped, M
    final, unchanged, at K1."""
    real = mask > 0
    return torch.stack([
        real.sum(), (skip & real).sum(), ((skip | in_m) & real).sum(),
        ((new_topics == topics) & real).sum(),
        ((new_topics == k1) & real).sum()]).to(torch.int64)


class _TrainerBase:
    """What the replicated and the parameter-server trainers share: host
    arrays to the device, count builds through ``histogram``, and the LLPT
    and count tripwire of the gathered global counts (``gather_global``),
    which the parameter server keeps (the replicated trainer reduces its
    own rows instead). Each names ``_boundary``, where its count tripwire
    fires."""

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _count(self, rows, topics, weights, n_rows: int) -> torch.Tensor:
        """(n_rows, K_loc) counts of tokens (the topics of this rank's
        block; others add nothing): the ``histogram`` kernel's any-order
        route with ``impl="kernel"``, its plain twin with ``"torch"``."""
        fn = _hist.histogram if self.cfg.impl == "kernel" else histogram_ref
        return fn(rows, topics - self.kb0 if self.kb0 else topics, weights,
                  n_rows=n_rows, n_topics=self.k_local)

    def _eval_arrays(self) -> list:
        """The single engine's padded token order (word, doc, mask), built
        once, in pinned host memory, uploaded a chunk at a time."""
        if self._eval is None:
            self._eval = [_pinned(a, self.device) for a in
                          _padded_order(self.corpus, self.cfg.tile_size)]
        return self._eval

    def evaluate(self, state) -> float:
        """Training LLPT from the gathered global counts over the single
        engine's padded token order, folded in chunks of whole tiles:
        bitwise the single engine's."""
        D, W = self.gather_global(state)
        score = _folded_llpt(self._eval_arrays(), D, W, self.cfg,
                             self.device)
        if self.cfg.selfcheck and not np.isfinite(score):
            raise invariants.InvariantViolation(
                "finite_llpt", f"evaluate (iteration "
                f"{int(state.iteration)})", f"llpt={score!r}")
        return score

    def selfcheck(self, state) -> None:
        """Count-invariant tripwire on the gathered global counts
        (``config.selfcheck``; a gather each time)."""
        D, W = self.gather_global(state)
        invariants.check_dense_counts(
            D, W, n_tokens=self.n_real_tokens,
            where=f"{self._boundary} (iteration {int(state.iteration)})")


# ---------------------------------------------------------------------------
# the replicated trainer
# ---------------------------------------------------------------------------

class DistLDATrainer(_TrainerBase):
    """One rank of the replicated multi-GPU EZLDA trainer.

    ``mesh`` must carry a ``model`` axis (size 1 reproduces the paper's
    pure data-parallel scheme) plus ``data`` (and optionally ``pod``);
    data shards = the data axes' extent, and K must divide by the model
    axis. Every rank of the mesh constructs its trainer and calls every
    method in the same order: most of them run collectives.

    With ``corpus_residency="streamed"`` (or "auto" past the card's
    budget) the rank's tokens stay on the host and an iteration is an
    epoch over their sub-shards (the reference's ``_StreamedDistMixin``):
    each sub-shard goes through the resident iteration's own sweep
    against the epoch-start counts, its ±1 moves accumulate in a D delta
    and the delta buffer, and the epoch close runs the resident
    iteration's all-reduces once. Integer adds commute, so streamed is
    bitwise resident on every mesh. The next sub-shard loads on a worker
    thread and a side CUDA stream while the current one samples.
    Every rank has the same ``n_sub`` and ``sub_len`` (every rank's slice
    is padded to one length), so every rank issues the same collectives.

    Engine-internal: this is the ``backend="distributed"`` backend of
    ``repro_torch.lda.api.LDAEngine`` (``dist.w_sync="replicate"``),
    which owns mesh defaulting, the canonical checkpoints and the serving
    export. Direct construction raises TypeError, as in the reference.
    """

    def __init__(self, corpus: Corpus, config: LDAConfig, mesh: ProcessMesh,
                 pad_multiple: int = 1024, *, device=None,
                 _from_engine: bool = False):
        if not _from_engine:
            raise TypeError(
                "DistLDATrainer is an engine-internal backend: construct "
                "through repro_torch.lda.api.LDAEngine(corpus, config, "
                "backend='distributed') — it wraps this trainer with "
                "unified checkpoints and the serving export path")
        if "model" not in mesh.shape:
            raise ValueError(
                f"mesh axes {tuple(mesh.shape)} lack a 'model' axis: the "
                "distributed trainer needs one (size 1 reproduces the "
                "paper's pure data-parallel scheme)")
        if config.sampler == "warp":
            raise ValueError(
                "sampler='warp' is single-backend only in this release: "
                "the MH doc proposal gathers topics of arbitrary same-doc "
                "tokens, and dissected documents would need remote topic "
                "gathers every proposal cycle. Use backend='single' for "
                "the warp engine, or sampler='three_branch' on this "
                "distributed trainer")
        self.cfg = config
        self.mesh = mesh
        self.data_axes = batch_axes(mesh)
        self.pm = mesh.shape["model"]
        if config.n_topics % self.pm != 0:
            raise ValueError(
                f"n_topics={config.n_topics} is not divisible by the model "
                f"mesh axis ({self.pm}): topic-axis model parallelism "
                "block-partitions K over the model shards")
        if config.format == "hybrid":
            if self.pm != 1:
                raise ValueError(
                    "format='hybrid' needs a model mesh axis of size 1: "
                    "packed ELL slots store GLOBAL topic ids, which do not "
                    "block-partition over the topic axis. Use a pure "
                    "data-parallel mesh (the paper's §V-B scheme) or "
                    "format='dense' for topic-axis model parallelism")
            if config.balance == "tiles":
                raise ValueError(
                    "balance='tiles' with format='hybrid' is not supported "
                    "on the distributed backend: dissected documents need "
                    "remote dense D-row deltas, which packed ELL rows "
                    "cannot absorb scatter-free. Use format='dense' for "
                    "token-balanced sharding, or balance='none' (document "
                    "chunking) with the hybrid state")
        self.device = resolve_device(device)
        self.corpus = corpus
        self.n_words = corpus.n_words
        self.n_real_tokens = corpus.n_tokens
        n = corpus.n_tokens
        # the single engine's padded length: every draw is taken over it
        self.n_padded_tokens = n + (-n) % config.tile_size
        self.k_local = config.n_topics // self.pm
        self.kb0 = mesh.axis_index("model") * self.k_local
        n_data = mesh_axis_size(mesh, self.data_axes)
        t0 = time.perf_counter()
        self.sc = shard_corpus(corpus, n_data, pad_multiple,
                               balance=config.balance)
        self.shard_seconds = time.perf_counter() - t0
        # "auto" keeps the shard resident unless it would stream it
        self.residency, self.n_stream_shards = resolve_residency(
            config, int(self.sc.word_ids.shape[1]), self.device)
        # this rank's data shard: row-major over the data axes, as
        # P(("pod", "data")) splits the reference's leading shard axis
        self.shard = int(np.ravel_multi_index(
            [mesh.axis_index(a) for a in self.data_axes],
            [mesh.shape[a] for a in self.data_axes])) \
            if self.data_axes else 0
        s, sc = self.shard, self.sc
        self.n_docs_local = int(sc.docs_per_shard[s])
        self.n_shared = 0 if sc.shared_rows is None \
            else int(sc.shared_rows.shape[1])
        self.shared_rows = None if sc.shared_rows is None \
            else self._to_dev(sc.shared_rows[s])
        self.stream = None
        if self.residency == "streamed":
            # the token arrays stay on the host; the pipeline's planner
            # reads them there
            self.stream = _build_stream(sc, s, max(self.n_stream_shards, 2),
                                        self.n_words - 1)
            st = self.stream
            tok = [torch.from_numpy(a) for a in (st.word_ids, st.doc_ids,
                                                 st.mask)]
            self.word_ids = self.doc_ids = self.mask = None
            self.global_pos = self.shared_slot = None
            self._gp = _pinned(st.global_pos, self.device)
            self._prefetch = _Prefetcher(
                deadline_s=config.stream_watchdog_seconds)
            self._side = torch.cuda.Stream(self.device) \
                if self.device.type == "cuda" else None
        else:
            self.word_ids = self._to_dev(sc.word_ids[s])
            self.doc_ids = self._to_dev(sc.doc_ids[s])
            self.mask = self._to_dev(sc.mask[s])
            self.global_pos = self._to_dev(sc.global_pos[s])
            self.shared_slot = None if sc.shared_slot is None \
                else self._to_dev(sc.shared_slot[s])
            tok = [self.word_ids, self.doc_ids, self.mask]
        self.pipe = None
        self.layout = None
        if self.pm == 1:
            kw = dict(n_docs=sc.m_local, n_words=self.n_words, config=config)
            if config.format == "hybrid":
                self.pipe = HybridFusedPipeline(*tok, corpus=corpus, **kw)
                self.layout = self.pipe.layout
            else:
                self.pipe = FusedPipeline(*tok, **kw)
            if self.stream is not None:
                self.pipe.capacity = min(self.pipe.capacity,
                                         self.stream.sub_len)
        # dW (V rows), Δcolsum (1 row) and the shared rows' ΔD (n_shared
        # rows): one buffer, one all-reduce an iteration
        self._delta = torch.zeros(
            (self.n_words + 1 + self.n_shared, self.k_local),
            dtype=torch.int32, device=self.device)
        self._ll_denom = None
        self.count_build_seconds = None
        # tokens a chunk of the topic-split sweep (results are per token)
        self.sweep_tokens = max(1024, SWEEP_CHUNK_BYTES // (4 * self.k_local))
        self.last_epoch_io: dict = {}

    _boundary = "distributed chunk boundary"

    def close(self) -> None:
        """Stop the streamed trainer's prefetch worker."""
        if self.stream is not None:
            self._prefetch.close()

    # -- counts --------------------------------------------------------------

    def _token_chunks(self, topics):
        """(word, doc, mask, topics) of this rank's tokens on the card: the
        resident arrays at once, or each sub-shard of the host ``topics``
        in turn."""
        if self.stream is None:
            yield self.word_ids, self.doc_ids, self.mask, topics
            return
        st = self.stream
        for r in range(st.n_sub):
            c = st.cols(r)
            yield (self._to_dev(st.word_ids[c]), self._to_dev(st.doc_ids[c]),
                   self._to_dev(st.mask[c]), self._to_dev(topics[c]))

    def _build_counts(self, topics) -> tuple:
        """Counts of this rank's topics, built on its device: local D and
        W (folded sub-shard by sub-shard when streamed; integer adds), W
        summed over the data axes, the shared rows' D too. Returns the
        format's counts tuple."""
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        D = W = None
        for word, doc, mask, t in self._token_chunks(topics):
            d = self._count(doc, t, mask, self.sc.m_local)
            w = self._count(word, t, mask, self.n_words)
            D, W = (d, w) if D is None else (D.add_(d), W.add_(w))
        self.mesh.psum(W, self.data_axes)
        if self.n_shared:
            # a dissected doc's row on each holder counts only its local
            # tokens: the sum over the data axes is the full global row
            rows = self.shared_rows.long()
            here = rows < self.sc.m_local
            dsh = torch.zeros((self.n_shared, self.k_local),
                              dtype=torch.int32, device=self.device)
            dsh[here] = D[rows[here]]
            self.mesh.psum(dsh, self.data_axes)
            D[rows[here]] = dsh[here]
        colsum = W.sum(dim=0, dtype=torch.int32)
        if sync:
            torch.cuda.synchronize(self.device)
        self.count_build_seconds = time.perf_counter() - t0
        if self.layout is None:
            return D, W, colsum
        w_head, w_tail = self.layout.split_w(W)
        return (self.layout.pack_d(D), w_head, w_tail, colsum,
                torch.zeros((), dtype=torch.int32, device=self.device))

    def _state_from_topics(self, topics, iteration: int):
        """This rank's state from its slots' topics: a device tensor
        (resident) or a host array in the sub-shard layout (streamed)."""
        counts = self._build_counts(topics)
        if self.stream is not None:
            return DistStreamState(host_topics=topics, counts=counts,
                                   iteration=int(iteration))
        kind = DistLDAState if self.layout is None else DistHybridState
        return kind(topics, *counts, int(iteration))

    def init_state(self):
        """The single-device initial draw (stream 0 over the padded token
        order), read at this rank's slots, and its counts."""
        full = esca.init_topics(
            uniforms_generator(self.cfg.seed, 0, self.device),
            (self.n_padded_tokens,), self.cfg.n_topics)
        if self.stream is None:
            return self._state_from_topics(full[self.global_pos], 0)
        gp = self._gp.to(self.device, non_blocking=True)
        topics = full[gp].cpu().numpy()
        del full, gp
        return self._state_from_topics(topics, 0)

    def _uniforms(self, iteration: int, global_pos) -> torch.Tensor:
        """Iteration ``iteration``'s single-device uniforms at the slots
        ``global_pos`` (pads read token 0's: their moves are masked out)."""
        return draw_uniforms(self.cfg.seed, iteration, self.n_padded_tokens,
                             self.device)[global_pos]

    # -- the iteration's pieces (resident and streamed share them) -----------

    @staticmethod
    def _counts_of(state) -> tuple:
        """The counts tuple of a resident or streamed state."""
        if isinstance(state, DistStreamState):
            return state.counts
        return tuple(state)[1:-1]

    def _open(self, counts) -> tuple:
        """(dense D, dense W, derived) of iteration-start counts: Ŵ and
        the word stats (model axis 1), or the topic split's word phase
        and document lengths."""
        cfg = self.cfg
        if self.layout is not None:
            D = sparse.densify_rows_sorted(counts[0], cfg.n_topics)
            W = self.layout.densify_w(counts[1], counts[2])
        else:
            D, W = counts[0], counts[1]
        colsum = counts[-2] if self.layout is not None else counts[2]
        if self.pm == 1:
            W_hat = esca.compute_w_hat_from_colsum(W, colsum, cfg.beta)
            return D, W, (W_hat, three_branch.word_stats(
                W_hat, g=cfg.g, alpha=cfg.alpha_))
        word = _word_phase(W, colsum, self.mesh, beta=cfg.beta,
                           alpha=cfg.alpha_, n_words=self.n_words, g=cfg.g,
                           kb0=self.kb0, k_local=self.k_local)
        len_tot = self.mesh.psum(D.sum(dim=-1, dtype=torch.float32), "model")
        return D, W, word + (len_tot,)

    def _sweep(self, D, d_packed, derived, u, word_ids, doc_ids):
        """New topics of a token list against fixed counts: the port's
        resident sampler body (model axis 1) or the reference's two-level
        inverse CDF in chunks of tokens. Returns (new_topics, skip, in_m,
        k1, survivors)."""
        cfg = self.cfg
        if self.pm == 1:
            pipe = self.pipe
            sparse_tail = None
            if self.layout is not None and cfg.tail_sampler == "sparse" \
                    and pipe.n_tail:
                sparse_tail = (d_packed, word_ids < self.layout.v_dense)
            dec, new_topics, in_m, survivors = pipe._sample(
                u, word_ids, doc_ids, D, *derived, capacity=pipe.capacity,
                win_words=pipe.win_words, sparse_tail=sparse_tail)
            if self.layout is not None:
                pipe.last_survivors = survivors
            n_surv = sum(survivors.values()) if self.layout is not None \
                else survivors["head"]
            return new_topics, dec.skip, in_m, dec.k1, n_surv
        W_hat, g_vals, g_idx, q_prime, len_tot = derived
        n = u.shape[0]
        new_topics = torch.empty(n, dtype=torch.int32, device=self.device)
        skip = torch.empty(n, dtype=torch.bool, device=self.device)
        in_m = torch.empty_like(skip)
        k1 = torch.empty_like(new_topics)
        step = self.sweep_tokens
        for lo in range(0, n, step):
            sl = slice(lo, min(lo + step, n))
            doc = doc_ids[sl]
            out = _token_sweep(
                u[sl], word_ids[sl], doc, D[doc.long()], len_tot,
                W_hat, g_vals, g_idx, q_prime, self.mesh, alpha=cfg.alpha_,
                g=cfg.g, kb0=self.kb0, k_local=self.k_local)
            new_topics[sl], skip[sl], in_m[sl], k1[sl] = out
        return new_topics, skip, in_m, k1, None

    def _stats(self, counts):
        """The reference's branch statistics: masked means over the real
        tokens of every data shard, summed as exact int64 counts."""
        self.mesh.psum(counts, self.data_axes)
        f = (counts[1:].double() / counts[0].clamp(min=1)).float()
        return three_branch.ThreeBranchStats(
            frac_skipped=f[0], frac_m_final=f[1], frac_unchanged=f[2],
            frac_at_max=f[3], frac_q_branch=torch.zeros((), device=f.device))

    @staticmethod
    def _moves(mask, topics, new_topics) -> _Moves:
        idx = ((new_topics != topics) & (mask > 0)).nonzero().squeeze(1)
        return _Moves(idx, topics[idx], new_topics[idx])

    def _scatter_block(self, counts, rows, mv: _Moves) -> None:
        """±1 moves of this rank's topic block (others add 0 at a clamped
        column)."""
        old, new = mv.old - self.kb0, mv.new - self.kb0
        hi = self.k_local - 1
        w_old = ((old >= 0) & (old <= hi)).to(torch.int32)
        w_new = ((new >= 0) & (new <= hi)).to(torch.int32)
        index = (torch.cat([old.clamp(0, hi), new.clamp(0, hi)]).long(),)
        if rows is not None:
            index = (torch.cat([rows, rows]).long(),) + index
        counts.index_put_(index, torch.cat([-w_old, w_new]),
                          accumulate=True)

    def _scatter_rows(self, counts, rows, mv: _Moves) -> None:
        if self.pm == 1:
            esca.scatter_moves(counts, rows, mv.old, mv.new)
        else:
            self._scatter_block(counts, rows, mv)

    def _scatter_deltas(self, mv: _Moves, word_ids, shared_slot) -> None:
        """±1 moves into the delta buffer: dW, Δcolsum and the shared
        rows' ΔD, in place (accumulating: the caller zeroes it)."""
        buf, V = self._delta, self.n_words
        self._scatter_rows(buf[:V], word_ids[mv.idx], mv)
        self._scatter_rows(buf[V], None, mv)
        if self.n_shared:
            # tokens of documents held by this shard alone carry the
            # sentinel slot n_shared: no shared row takes their moves
            slot = shared_slot[mv.idx]
            keep = slot < self.n_shared
            self._scatter_rows(buf[V + 1:], slot[keep], _Moves(
                mv.idx[keep], mv.old[keep], mv.new[keep]))

    def _scatter(self, dD, mv: _Moves, doc_ids, word_ids,
                 shared_slot) -> None:
        """±1 moves into this rank's D (or its D delta) and the delta
        buffer."""
        self._scatter_rows(dD, doc_ids[mv.idx], mv)
        self._scatter_deltas(mv, word_ids, shared_slot)

    def _land(self, D, W, counts) -> tuple:
        """The iteration's close: dW (and the shared rows' ΔD) summed over
        the data axes and added to every replica, the paper's
        sum-and-broadcast; D already holds this rank's moves. Hybrid
        repacks. Returns the new counts tuple."""
        buf, V = self._delta, self.n_words
        colsum = counts[-2] if self.layout is not None else counts[2]
        local_sh = buf[V + 1:].clone() if self.n_shared else None
        self.mesh.psum(buf, self.data_axes)
        W += buf[:V]
        colsum += buf[V]
        if self.n_shared:
            # the other holders' moves of each dissected doc's row
            rows = self.shared_rows.long()
            here = rows < self.sc.m_local
            remote = buf[V + 1:] - local_sh
            D.index_put_((rows[here],), remote[here], accumulate=True)
        if self.layout is None:
            return D, W, colsum
        d_packed, w_head, w_tail, overflow = repack_counts(
            self.layout, D, W, counts[-1])
        return d_packed, w_head, w_tail, colsum, overflow

    # -- the resident iteration ----------------------------------------------

    def _step(self, state):
        topics, it = state.topics, int(state.iteration)
        counts = self._counts_of(state)
        D, W, derived = self._open(counts)
        new_topics, skip, in_m, k1, n_surv = self._sweep(
            D, counts[0], derived, self._uniforms(it, self.global_pos),
            self.word_ids, self.doc_ids)
        del derived
        stats = self._stats(_branch_counts(self.mask, skip, in_m,
                                                new_topics, topics, k1))
        if n_surv is None:
            n_surv = int((~skip & (self.mask > 0)).sum())
        del skip, in_m, k1
        self._delta.zero_()
        self._scatter(D, self._moves(self.mask, topics, new_topics),
                      self.doc_ids, self.word_ids, self.shared_slot)
        counts = self._land(D, W, counts)
        kind = DistLDAState if self.layout is None else DistHybridState
        span = self.pipe.last_span if self.pipe is not None else 0
        return kind(new_topics, *counts, it + 1), stats, n_surv, span

    # -- the streamed epoch --------------------------------------------------

    def _to_device(self, host: list) -> _Staged:
        if self.device.type != "cuda":
            return _Staged(host, None, host)
        pinned = [t.pin_memory() for t in host]
        with torch.cuda.stream(self._side):
            dev = [t.to(self.device, non_blocking=True) for t in pinned]
            ev = torch.cuda.Event()
            ev.record(self._side)
        self.last_epoch_io["h2d_bytes"] += sum(
            t.numel() * t.element_size() for t in pinned)
        return _Staged(dev, ev, pinned)

    def _put_sub(self, r: int, host_topics: np.ndarray,
                 u_host: torch.Tensor) -> _Staged:
        """Sub-shard ``r``'s (word, doc, mask, topics, u[, shared slot])
        staged on the device (the prefetch thread runs it, but for an
        epoch's first sub-shard)."""
        if chaos.armed():
            chaos.io_fault(r)
        st = self.stream
        c = st.cols(r)
        host = [torch.from_numpy(a[c]) for a in (st.word_ids, st.doc_ids,
                                                 st.mask, host_topics)]
        host.append(u_host[c])
        if st.shared_slot is not None:
            host.append(torch.from_numpy(st.shared_slot[c]))
        return self._to_device(host)

    def _open_epoch(self, ss: DistStreamState) -> _DistEpochCarry:
        self.last_epoch_io = {"h2d_bytes": 0, "d2h_bytes": 0,
                              "take_wait_s": 0.0, "sub_s": [],
                              "t_open": time.perf_counter()}
        u = self._uniforms(ss.iteration,
                           self._gp.to(self.device, non_blocking=True))
        u_host = torch.empty(u.shape, dtype=torch.float32,
                             pin_memory=self.device.type == "cuda")
        u_host.copy_(u)
        del u
        D, W, derived = self._open(ss.counts)
        self._delta.zero_()
        return _DistEpochCarry(
            D=D, W=W, derived=derived, u_host=u_host, dD=torch.zeros_like(D),
            counts=torch.zeros(5, dtype=torch.int64, device=self.device))

    def _sample_sub(self, ss: DistStreamState, window: list):
        """Sample one staged sub-shard against the epoch-start counts; its
        moves go into the epoch's D delta and the delta buffer. Returns
        its new topics."""
        ep = ss.epoch
        word, doc, mask, topics, u = window[:5]
        new_topics, skip, in_m, k1, n_surv = self._sweep(
            ep.D, ss.counts[0], ep.derived, u, word, doc)
        counts = _branch_counts(mask, skip, in_m, new_topics, topics, k1)
        if n_surv is None:
            n_surv = int((~skip & (mask > 0)).sum())
        self._scatter(ep.dD, self._moves(mask, topics, new_topics), doc,
                      word, window[5] if self.n_shared else None)
        # the epoch's carry takes the sub-shard only once its moves landed
        ep.counts += counts
        ep.n_surv += n_surv
        if self.pipe is not None:
            ep.span = max(ep.span, self.pipe.last_span)
        return new_topics

    def _land_pending(self, ss: DistStreamState, keep: int) -> None:
        """Land the open epoch's deferred topic readbacks on the host
        until ``keep`` remain."""
        pending, start = ss.epoch.pending, ss.epoch.start
        while len(pending) > keep:
            r, rb = pending.pop(0)
            c = self.stream.cols(r)
            if start is not None:
                start[r] = ss.host_topics[c].copy()
            ss.host_topics[c] = rb.get()

    def _stream_epoch(self, ss: DistStreamState, stop: int | None = None):
        """One epoch (resuming an open one at ``ss.cursor``): (state,
        stats, survivors, widest span). With ``stop`` (``run_shards``) it
        samples the sub-shards before ``stop`` only and leaves the epoch
        open, returning (state, None, 0, 0); an epoch it opens keeps its
        sampled sub-shards' start topics for a mid-epoch payload."""
        st = self.stream
        close = stop is None
        stop = st.n_sub if close else min(int(stop), st.n_sub)
        if ss.epoch is None:
            ss.epoch = self._open_epoch(ss)
            if not close:
                ss.epoch.start = {}
        ep, io = ss.epoch, self.last_epoch_io
        # an epoch resumed after a fault: the sampled sub-shards' topics
        self._land_pending(ss, keep=0)
        self._prefetch.take()                    # drop any stale prefetch
        staged = self._put_sub(ss.cursor, ss.host_topics, ep.u_host) \
            if ss.cursor < stop else None
        while ss.cursor < stop:
            r = ss.cursor
            t0 = time.perf_counter()
            if chaos.armed():
                chaos.shard_event(ss.iteration, r)
            window = staged.claim()
            if r + 1 < stop:
                self._prefetch.submit(self._put_sub, r + 1, ss.host_topics,
                                      ep.u_host)
            new_t = self._sample_sub(ss, window)
            ep.pending.append((r, _read_back(new_t)))
            if self.device.type == "cuda":
                io["d2h_bytes"] += new_t.numel() * 4
            del window, staged, new_t
            # one deep: sub-shard r-1's topics land once r is queued
            self._land_pending(ss, keep=1)
            ss.cursor += 1
            t1 = time.perf_counter()
            staged = self._prefetch.take()
            io["take_wait_s"] += time.perf_counter() - t1
            io["sub_s"].append(time.perf_counter() - t0)
        self._land_pending(ss, keep=0)
        if not close:
            return ss, None, 0, 0
        stats = self._stats(ep.counts)
        ep.D += ep.dD
        ss.counts = self._land(ep.D, ep.W, ss.counts)
        ss.iteration += 1
        ss.cursor = 0
        ss.epoch = None
        if "t_open" in io:
            io["epoch_s"] = time.perf_counter() - io.pop("t_open")
        return ss, stats, ep.n_surv, ep.span

    # -- drivers ---------------------------------------------------------------

    def step(self, state):
        """One iteration: (state, stats). Updates ``state``'s count
        tensors in place."""
        if isinstance(state, DistStreamState):
            raise ValueError(
                "a streamed distributed trainer advances by whole epochs "
                "(every token sub-shard must stream through before the "
                "counts apply): use run_fused(state, n_iters)")
        state, stats, _, _ = self._step(state)
        return state, stats

    def run_fused(self, state, n_iters: int):
        """``n_iters`` iterations (epochs when streamed): (state, stats
        stacked along a leading (n_iters,) axis). The survivor counts
        re-plan the sampler's chunk capacity (and the tiles' window) for
        the next call, as the single-device pipeline's ``run_fused``
        does."""
        if chaos.armed():
            chaos.step_range(int(state.iteration), int(n_iters))
        stats, n_surv, spans = [], [], []
        for _ in range(int(n_iters)):
            if isinstance(state, DistStreamState):
                state, st, ns, span = self._stream_epoch(state)
            else:
                state, st, ns, span = self._step(state)
            stats.append(st)
            n_surv.append(ns)
            spans.append(span)
        kind = three_branch.ThreeBranchStats
        stacked = kind(*(torch.stack([torch.as_tensor(getattr(s, f))
                                      for s in stats]) if stats
                         else torch.zeros(0) for f in kind._fields))
        if self.pipe is not None and stats:
            self.pipe.note_survivors(torch.tensor(n_surv))
            if self.stream is not None:
                self.pipe.capacity = min(self.pipe.capacity,
                                         self.stream.sub_len)
            if self.pipe.balance == "tiles":
                self.pipe.note_spans(spans)
        return state, stacked

    def run_shards(self, ss: DistStreamState, n_shards: int = 1
                   ) -> DistStreamState:
        """Sample the next ``n_shards`` sub-shards of the open epoch (opening
        one at the epoch boundary), leaving it open: the mid-epoch surface
        of a supervised fit's ``checkpoint_shards``. ``host_payload`` then
        gives a mid-epoch payload, and ``run_fused(ss, 1)`` closes the
        epoch once every sub-shard is sampled. Every rank samples the same
        sub-shard indices, so the ranks stay in step."""
        if not isinstance(ss, DistStreamState):
            raise ValueError(
                "run_shards needs a streamed distributed state "
                "(corpus_residency='streamed'): a resident iteration has no "
                "sub-shards to stop between")
        return self._stream_epoch(ss, stop=ss.cursor + int(n_shards))[0]

    # -- checkpoints (global token order: elastic across meshes) --------------

    def _local_topics(self, state):
        """(topics, mask, global_pos) of this rank's resident slots:
        device tensors, or host arrays when streamed."""
        if self.stream is None:
            return state.topics, self.mask, self.global_pos
        s, n = self.shard, self.stream.n_loc
        return (state.host_topics[:n], self.sc.mask[s],
                self.sc.global_pos[s])

    def _global_topics(self, topics, mask, gp) -> np.ndarray:
        """The real tokens' topics in global order: one sum of a zero (N,)
        buffer over the data axes with each rank's real slots written."""
        real = mask > 0
        if isinstance(topics, np.ndarray):
            out = np.zeros(self.n_real_tokens, np.int32)
            out[gp[real]] = topics[real]
            out = torch.from_numpy(out).to(self.device)
        else:
            out = torch.zeros(self.n_real_tokens, dtype=torch.int32,
                              device=self.device)
            out[gp[real]] = topics[real]
        return self.mesh.psum(out, self.data_axes).cpu().numpy()

    def host_payload(self, state) -> dict:
        """The canonical payload: ``topics_global`` (``_global_topics``),
        the key data and the iteration (on every rank).

        A streamed state checkpoints at epoch boundaries, as in the
        reference, or inside an epoch that ``run_shards`` opened: then
        ``topics_global`` holds the epoch-start topics and
        ``dist_stream_topics_global`` the current ones (the sampled
        sub-shards' new topics), with ``dist_stream_cursor`` and the
        sub-shard grid (``dist_stream_n_sub``, ``dist_stream_n_data``) a
        restore must match. Any other engine reads such a payload as the
        epoch's start, which redoes the epoch to the same bits."""
        if isinstance(state, DistStreamState) and state.cursor:
            if state.epoch is None or state.epoch.start is None:
                raise ValueError(
                    "streamed distributed states checkpoint at epoch "
                    f"boundaries only, but {state.cursor} sub-shards of "
                    "the open epoch are sampled: finish the epoch "
                    "(run_fused) first, or open it with run_shards, whose "
                    "epochs keep what a mid-epoch payload needs")
            return self._mid_epoch_payload(state)
        topics, mask, gp = self._local_topics(state)
        return {"topics_global": self._global_topics(topics, mask, gp),
                "key": key_data(self.cfg.seed),
                "iteration": int(state.iteration)}

    def _mid_epoch_payload(self, ss: DistStreamState) -> dict:
        st, s = self.stream, self.shard
        self._land_pending(ss, keep=0)
        start = ss.host_topics.copy()
        for r, old in ss.epoch.start.items():
            start[st.cols(r)] = old
        mask, gp = self.sc.mask[s], self.sc.global_pos[s]
        n = st.n_loc
        return {"topics_global": self._global_topics(start[:n], mask, gp),
                "key": key_data(self.cfg.seed),
                "iteration": int(ss.iteration),
                "dist_stream_cursor": np.int64(ss.cursor),
                "dist_stream_n_sub": np.int64(st.n_sub),
                "dist_stream_n_data": np.int64(self.sc.n_shards),
                "dist_stream_topics_global": self._global_topics(
                    ss.host_topics[:n], mask, gp)}

    def state_from_payload(self, payload: dict):
        """This rank's state from a canonical payload of any mesh or
        engine: the topics at its slots, the counts rebuilt."""
        if int(np.asarray(payload.get("stream_cursor", 0))) > 0:
            raise ValueError(
                "mid-epoch streaming checkpoints restore on the single-"
                "host backend only; this distributed trainer needs an "
                "epoch-boundary payload (no stream_cursor)")
        tg = np.asarray(payload["topics_global"], np.int32)
        if tg.shape[0] != self.n_real_tokens:
            raise ValueError(
                f"checkpoint topics_global has {tg.shape[0]} entries but "
                f"the corpus holds {self.n_real_tokens} tokens: the "
                "checkpoint belongs to a different corpus")
        k = self.cfg.n_topics
        if tg.size and (tg.min() < 0 or tg.max() >= k):
            raise ValueError(f"checkpoint topics lie outside [0, {k})")
        it = int(payload["iteration"])
        cursor = int(np.asarray(payload.get("dist_stream_cursor", 0)))
        if cursor:
            return self._mid_epoch_state(payload, tg, it, cursor)
        # pads read token 0's topic: mask 0, so they count nowhere
        if self.stream is not None:
            return self._state_from_topics(tg[self.stream.global_pos], it)
        full = torch.from_numpy(tg).to(self.device)
        return self._state_from_topics(full[self.global_pos], it)

    def _mid_epoch_state(self, payload: dict, tg: np.ndarray, it: int,
                         cursor: int) -> DistStreamState:
        """A streamed state inside its epoch, from ``host_payload``'s
        mid-epoch keys: the counts of the epoch-start topics, the epoch
        re-opened, and the sampled sub-shards' moves (start -> current
        topics) scattered into its deltas, integer adds as when they were
        sampled. The branch statistics of the sampled sub-shards are not
        in the payload: the epoch's statistics count the rest."""
        st = self.stream
        grid = (int(payload["dist_stream_n_data"]),
                int(payload["dist_stream_n_sub"]))
        if st is None or grid != (self.sc.n_shards, st.n_sub) \
                or not 0 < cursor <= st.n_sub:
            have = "resident" if st is None else \
                f"{self.sc.n_shards} data shards of {st.n_sub} sub-shards"
            raise ValueError(
                f"mid-epoch checkpoint of the streamed distributed trainer "
                f"(cursor {cursor}, {grid[0]} data shards of {grid[1]} "
                f"sub-shards) does not fit this trainer ({have}): restore "
                "it on the same data shards and stream_shards, or drop its "
                "dist_stream_* keys to redo the epoch from its start")
        ss = self._state_from_topics(tg[st.global_pos], it)
        cur = np.asarray(payload["dist_stream_topics_global"],
                         np.int32)[st.global_pos]
        ss.epoch = self._open_epoch(ss)
        ss.epoch.start = {}
        for r in range(cursor):
            c = st.cols(r)
            word, doc, mask, old, new = (self._to_dev(a[c]) for a in (
                st.word_ids, st.doc_ids, st.mask, ss.host_topics, cur))
            shared = self._to_dev(st.shared_slot[c]) if self.n_shared \
                else None
            self._scatter(ss.epoch.dD, self._moves(mask, old, new), doc,
                          word, shared)
            ss.epoch.start[r] = ss.host_topics[c].copy()
            ss.host_topics[c] = cur[c]
        ss.cursor = cursor
        return ss

    # -- global views ---------------------------------------------------------

    def dense_rows(self, state) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's (D rows, W replica) as dense int32 blocks."""
        counts = self._counts_of(state)
        if self.layout is None:
            return counts[0], counts[1]
        lay = self.layout
        return (sparse.densify_rows_sorted(counts[0], lay.n_topics),
                lay.densify_w(counts[1], counts[2]))

    def global_W(self, state) -> torch.Tensor:
        """The (V, K) int32 W on this rank's device, with no D: the rank's
        replica, gathered over ``model`` when the topics are split (then
        a collective)."""
        return self._whole_topics(self.dense_rows(state)[1])

    def _whole_topics(self, x: torch.Tensor) -> torch.Tensor:
        """Rows of this rank's topic block with every topic: gathered over
        ``model`` (a collective) when the topics are split."""
        if self.pm == 1:
            return x
        return self.mesh.all_gather(x, "model").movedim(0, 1).reshape(
            x.shape[0], -1)

    def gather_global(self, state) -> tuple[torch.Tensor, torch.Tensor]:
        """The global (D (M, K), W (V, K)) int32 count matrices on this
        rank's device: each document counted once, through its gather
        owner under tiles (a collective: every rank calls it). Tests and
        the parameter server's callers read it; training never builds
        the global D."""
        D_loc, W_loc = self.dense_rows(state)
        s, nd, K = self.shard, self.n_docs_local, self.cfg.n_topics
        rows = self.sc.doc_map[s][:nd]
        sel = np.arange(nd)
        if self.sc.owns is not None:
            sel = np.flatnonzero(self.sc.owns[s][:nd] > 0)
        D = torch.zeros((self.corpus.n_docs, K), dtype=torch.int32,
                        device=self.device)
        cols = slice(self.kb0, self.kb0 + self.k_local)
        D[torch.from_numpy(rows[sel]).to(self.device), cols] = \
            D_loc[torch.from_numpy(sel).to(self.device)]
        if self.pm == 1:
            self.mesh.psum(D, self.data_axes)
            return D, W_loc
        self.mesh.psum(D, self.mesh.axis_names)
        W = torch.zeros((self.n_words, K), dtype=torch.int32,
                        device=self.device)
        W[:, cols] = W_loc
        return D, self.mesh.psum(W, "model")

    # -- the LLPT and the tripwire, each rank over its own rows --------------

    def _eval_tokens(self):
        """(word, doc, mask, global_pos) of this rank's slots on its device,
        in about ``EVAL_CHUNKS`` pieces (views of the resident arrays) or
        each sub-shard from the host."""
        if self.stream is None:
            n = int(self.word_ids.shape[0])
            step = max(1, -(-n // EVAL_CHUNKS))
            for lo in range(0, n, step):
                yield (self.word_ids[lo:lo + step], self.doc_ids[lo:lo + step],
                       self.mask[lo:lo + step],
                       self.global_pos[lo:lo + step])
            return
        st = self.stream
        for r in range(st.n_sub):
            c = st.cols(r)
            yield tuple(self._to_dev(a[c]) for a in (
                st.word_ids, st.doc_ids, st.mask, st.global_pos))

    def _ll_denominator(self) -> torch.Tensor:
        """``reduce_ll``'s denominator over the single engine's padded
        order (the float32 sum of its mask), computed once."""
        if self._ll_denom is None:
            m = torch.zeros(self.n_padded_tokens, dtype=torch.float32,
                            device=self.device)
            m[:self.n_real_tokens] = 1.0
            self._ll_denom = torch.clamp(m.sum(), min=1.0)
        return self._ll_denom

    def evaluate(self, state) -> float:
        """Training LLPT with no global D: each rank evaluates its own real
        tokens against its own D rows (every topic of them: gathered over
        ``model`` when the topics are split, each model rank then taking
        a share of the tokens) and the W replica, a tile at a time with no
        θ (``core/llpt.py::token_ll``), and writes each value at its token's position in the single engine's
        padded order, an ``(n_padded,)`` float32 buffer that is zero
        elsewhere. One all-reduce over the mesh fills it: a token lives on
        one rank (a dissected document's row is whole on each holder), so
        every sum adds zeros to one value, exactly. ``token_ll``'s values
        depend on a token's rows alone, so the buffer is the single
        engine's per-token vector, and its sum (the padding's products
        with the mask are zeros) over the same denominator is the single
        engine's LLPT, bitwise."""
        cfg = self.cfg
        denom = self._ll_denominator()
        D, W = (self._whole_topics(x) for x in self.dense_rows(state))
        colsum = W.sum(dim=0, dtype=torch.float32)
        buf = torch.zeros(self.n_padded_tokens, dtype=torch.float32,
                          device=self.device)
        part = self.mesh.axis_index("model")
        for word, doc, mask, gp in self._eval_tokens():
            real = (mask > 0).nonzero().squeeze(1)
            if self.pm > 1:
                real = real.tensor_split(self.pm)[part]
            buf[gp[real]] = llpt_mod.token_ll(
                word[real], doc[real], D, W, colsum, alpha=cfg.alpha_,
                beta=cfg.beta, n_words=self.n_words, tile_size=cfg.tile_size)
        del D, W
        self.mesh.psum(buf, self.mesh.axis_names)
        score = float(buf.sum() / denom)
        if cfg.selfcheck and not np.isfinite(score):
            raise invariants.InvariantViolation(
                "finite_llpt", f"evaluate (iteration "
                f"{int(state.iteration)})", f"llpt={score!r}")
        return score

    def selfcheck(self, state) -> None:
        """Count-invariant tripwire with no global D: each rank reduces its
        D rows (a dissected document's row through its gather owner only)
        and its W block, one sum and one min across the ranks (W's sum
        over the model axis of the first data shard), then the checks of
        ``invariants.check_dense_counts``."""
        D, W = self.dense_rows(state)
        rows = D[:self.n_docs_local]
        if self.sc.owns is not None:
            own = self.sc.owns[self.shard][:self.n_docs_local] > 0
            rows = rows[torch.from_numpy(own).to(self.device)]
        dev = self.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        sums = torch.stack([rows.sum(dtype=torch.int64),
                            W.sum(dtype=torch.int64) if self.shard == 0
                            else zero])
        mins = torch.stack([rows.min().to(torch.int64) if rows.numel()
                            else zero, W.min().to(torch.int64)
                            if W.numel() else zero]).clamp(max=0)
        self.mesh.psum(sums, self.mesh.axis_names)
        self.mesh.pmin(mins, self.mesh.axis_names)
        (td, tw), (dmin, wmin) = sums.tolist(), mins.tolist()
        invariants.check_count_totals(
            dmin, wmin, td, tw, n_tokens=self.n_real_tokens,
            where=f"{self._boundary} (iteration {int(state.iteration)})")

    def state_nbytes(self, state) -> int:
        """Live count-state bytes on this rank: its D rows, its W replica
        (packed for the hybrid format) and the column sum."""
        counts = self._counts_of(state)
        parts = counts[:3] if self.layout is None else \
            [counts[0], counts[1], *counts[2], counts[3]]
        return int(sum(t.numel() for t in parts)) * 4


# ---------------------------------------------------------------------------
# the parameter-server trainer (w_sync="ps")
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PSEpochCarry:
    """One worker's open round: its uniforms staged on the host, the
    global column sum pulled from the server, its round-start dense D
    block, the accumulated D delta, and the round-start topics (the
    canonical cut a mid-round checkpoint restores from)."""
    u_host: torch.Tensor           # (R·L,) float32
    colsum: torch.Tensor           # (K,) int32, exact, from the server
    D: torch.Tensor                # (M_loc, K) int32 round-start counts
    dD: torch.Tensor               # (M_loc, K) int32 accumulator
    start_topics: np.ndarray       # (R·L,) int32 round-start copy
    n_surv: float = 0.0
    stat_sums: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float64))


@dataclasses.dataclass
class PSStreamState:
    """Training state under ``w_sync="ps"``: every worker's token topics
    on the host, its D block on the card, and W only in the word-sharded
    parameter server (``repro_torch.lda.ps``): a worker samples against
    one page of W rows. (The count build at init and restore and every
    evaluation's ``gather_global`` put the whole W on the card for a
    moment.)

    ``clocks[w]`` counts the rounds (epochs) worker ``w`` has finished;
    the state's ``iteration`` is the slowest worker's clock, which equals
    the server's committed round."""
    host_topics: np.ndarray        # (S, R·L) int32
    d_blocks: list                 # per worker (M_loc, K) dense or packed
    server: ps_mod.ParameterServer
    clients: list                  # ps.PSClient per worker (its journal)
    clocks: np.ndarray             # (S,) int64 rounds finished per worker
    cursors: np.ndarray            # (S,) int64 sub-shards of the open round
    epochs: list                   # per worker _PSEpochCarry | None
    overflow: int = 0              # hybrid repack tripwire (global)
    stat_rounds: dict = dataclasses.field(default_factory=dict)

    @property
    def iteration(self) -> int:
        return int(self.clocks.min())

    @property
    def topics(self) -> np.ndarray:
        return self.host_topics


class PSDistTrainer(_TrainerBase):
    """Word-sharded parameter-server EZLDA trainer (``w_sync="ps"``).

    The reference's ``PSDistTrainer``: the replicated trainer's document
    chunking and per-token math, but W is never replicated. The
    ``ParameterServer`` owns contiguous word ranges of W on the host; a
    worker pulls the page of rows its current token sub-shard touches
    (plus the global column sum), sweeps the sub-shard against it, and
    pushes the page's int32 delta back; a stale-synchronous clock
    (``DistConfig.staleness``) bounds worker skew, and a round commits
    when every worker has finished it.

    One process: the reference runs every worker on its mesh's first
    device; here every worker runs in the calling process, on the
    engine's one device, one after the other, with no process group. The
    worker grid is ``grid`` (axis -> extent), data shards its data axes'
    extent. A worker's sub-shard goes through ``FusedPipeline._sample``
    (the ``sample_fused`` kernel; ``sample_sparse`` for the hybrid tail)
    with page-relative word ids against Ŵ and the word stats of the page:
    both are row-wise and ΣŴ is summed pairwise on the card
    (``three_branch.row_sum``), so a page's rows are the full matrix's.

    Each worker reads the single-device uniforms at its tokens' global
    positions (as the replicated ranks do) and, at ``staleness=0``, a
    round-``c`` pull sees exactly the counts after ``c`` iterations: a
    PS run is then bitwise the single-device run and the replicated run
    (topics, D, W, every LLPT). Counts at init and restore are built on
    the device by the ``histogram`` kernel.

    Restrictions (the reference's): model axis 1, ``balance="none"``, the
    three-branch sampler, no disk residency. Mid-round checkpoints
    (``host_payload`` with open rounds) carry the canonical round-start
    topics plus the ``ps_*`` keys of ``checkpoint/ps_payload.py``;
    restores re-derive the open rounds' D deltas and pushes from them.
    """

    def __init__(self, corpus: Corpus, config: LDAConfig, grid: dict,
                 pad_multiple: int = 1024, *, device=None,
                 _from_engine: bool = False):
        if not _from_engine:
            raise TypeError(
                "PSDistTrainer is an engine-internal backend: construct "
                "through repro_torch.lda.api.LDAEngine with "
                "LDAConfig(dist=DistConfig(w_sync='ps', ...))")
        grid = {str(a): int(e) for a, e in dict(grid).items()}
        if "model" not in grid:
            raise ValueError(
                f"mesh axes {tuple(grid)} lack a 'model' axis")
        if grid["model"] != 1:
            raise ValueError(
                "w_sync='ps' needs a model mesh axis of size 1: W pages "
                "are row windows of the global matrix, and topic-block "
                "sharding a window would re-replicate the columns the "
                "parameter server exists to shard. Use topic-axis model "
                "parallelism with w_sync='replicate'")
        if config.balance != "none":
            raise ValueError(
                "w_sync='ps' requires balance='none': tiles replicate "
                "dissected documents' D rows and glue them with a "
                "per-iteration cross-shard psum, which contradicts "
                "independent worker progress under a staleness bound")
        if config.sampler == "warp":
            raise ValueError(
                "sampler='warp' is single-backend only (see "
                "DistLDATrainer); w_sync='ps' uses the three-branch sweep")
        if resolves_to_disk(config):
            raise ValueError(
                "w_sync='ps' streams host-staged token shards; the "
                "disk-native corpus store is not yet plumbed through the "
                "PS epoch loop (use w_sync='replicate' for "
                "corpus_residency='disk')")
        self.cfg = config
        self.dist_cfg = config.dist
        self.grid = grid
        self.corpus = corpus
        self.device = resolve_device(device)
        self.data_axes = tuple(a for a in ("pod", "data") if a in grid)
        S = int(np.prod([grid[a] for a in self.data_axes]))
        V, K = corpus.n_words, config.n_topics
        self.n_words = V
        self.n_real_tokens = corpus.n_tokens
        n = corpus.n_tokens
        self.n_padded_tokens = n + (-n) % config.tile_size
        self.kb0, self.k_local = 0, K
        t0 = time.perf_counter()
        self.sc = shard_corpus(corpus, S, pad_multiple, balance="none")
        self.shard_seconds = time.perf_counter() - t0

        # -- sub-shards: each worker's slice tiled as a streamed rank's ----
        n_loc = int(self.sc.word_ids.shape[1])
        self.residency, n_stream = resolve_residency(config, n_loc,
                                                     self.device)
        R = max(int(n_stream), 2) if self.residency == "streamed" \
            else max(int(config.stream_shards or 4), 2)
        self.streams = [_build_stream(self.sc, w, R, V - 1)
                        for w in range(S)]
        L = self.streams[0].sub_len
        self._R, self._L, self._n_loc = R, L, n_loc
        self._gp = [_pinned(st.global_pos, self.device)
                    for st in self.streams]

        # per-(worker, sub-shard) word runs -> one page geometry: the
        # widest run (at least PAGE_ROWS_FLOOR rows, for row_sum), bases
        # clamped into [0, V - P]
        spans = np.ones((S, R), np.int64)
        lows = np.zeros((S, R), np.int64)
        for w, st in enumerate(self.streams):
            for r in range(R):
                c = st.cols(r)
                m = st.mask[c] > 0
                if m.any():
                    wr = st.word_ids[c][m]
                    lows[w, r] = int(wr[0])          # word-sorted blocks
                    spans[w, r] = int(wr[-1]) - int(wr[0]) + 1
        P = int(min(max(int(spans.max()), PAGE_ROWS_FLOOR), V))
        self.page_rows = P
        self._bases = np.minimum(lows, V - P).astype(np.int64)
        # each worker's word ids relative to its sub-shards' page bases
        self._word_rel = [np.clip(st.word_ids - np.repeat(self._bases[w], L),
                                  0, P - 1).astype(np.int32)
                          for w, st in enumerate(self.streams)]

        # -- ownership -------------------------------------------------------
        dc = self.dist_cfg
        n_owners = dc.n_owners if dc.n_owners is not None else S
        row_mass = np.bincount(corpus.word_ids, minlength=V) \
            if dc.owner_layout == "mass" else None
        self.owner_layout = ps_mod.OwnerLayout.build(
            V, n_owners, layout=dc.owner_layout, row_mass=row_mass)

        # -- the sampler body: the port's resident pipeline, whose planner
        # reads worker 0's host arrays (tiles are off: balance="none") ------
        st = self.streams[0]
        tok = [torch.from_numpy(a) for a in (st.word_ids, st.doc_ids,
                                             st.mask)]
        kw = dict(n_docs=self.sc.m_local, n_words=V, config=config)
        self.layout = None
        if config.format == "hybrid":
            self.pipe = HybridFusedPipeline(*tok, corpus=corpus, **kw)
            self.layout = self.pipe.layout
        else:
            self.pipe = FusedPipeline(*tok, **kw)
        self.pipe.capacity = min(self.pipe.capacity, L)
        cuda = self.device.type == "cuda"
        # pinned host windows of one page, reused by every pull and push
        self._page_in = torch.empty((P, K), dtype=torch.int32,
                                    pin_memory=cuda)
        self._page_out = torch.empty((P, K), dtype=torch.int32,
                                     pin_memory=cuda)
        self._eval = None
        self.count_build_seconds = None
        self.io = self._zero_io()

    @staticmethod
    def _zero_io() -> dict:
        """Host-side accounting of the rounds since the last reset:
        seconds in pulls, sampling, pushes and round commits, bytes
        pulled and pushed, sub-shards and rounds run."""
        return {"pull_s": 0.0, "sample_s": 0.0, "push_s": 0.0,
                "commit_s": 0.0, "pull_bytes": 0, "push_bytes": 0,
                "subs": 0, "rounds": 0}

    _boundary = "ps round boundary"

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Nothing to stop: the workers run in the caller's thread."""

    # -- state construction --------------------------------------------------

    def _make_state(self, topics: np.ndarray, clock: int) -> PSStreamState:
        """A state at an aligned ``clock`` from every worker's topics
        (S, R·L): D blocks and W built on the card by the ``histogram``
        kernel, sub-shard by sub-shard, and W loaded into the server."""
        S, R, K = self.sc.n_shards, self._R, self.cfg.n_topics
        self._sync()
        t0 = time.perf_counter()
        W = torch.zeros((self.n_words, K), dtype=torch.int32,
                        device=self.device)
        d_blocks = []
        for w, st in enumerate(self.streams):
            D = None
            for r in range(R):
                c = st.cols(r)
                t, m = self._to_dev(topics[w, c]), self._to_dev(st.mask[c])
                d = self._count(self._to_dev(st.doc_ids[c]), t, m,
                                self.sc.m_local)
                D = d if D is None else D.add_(d)
                W += self._count(self._to_dev(st.word_ids[c]), t, m,
                                 self.n_words)
            d_blocks.append(D if self.layout is None
                            else self.layout.pack_d(D))
        server = ps_mod.ParameterServer(
            self.owner_layout, K, S, staleness=self.dist_cfg.staleness)
        server.load_global(W.cpu().numpy())
        del W
        server.committed = int(clock)
        server.ckpt_clock = int(clock)
        clients = []
        for w in range(S):
            c = ps_mod.PSClient(server, w)
            c.clock = int(clock)
            clients.append(c)
        self._sync()
        self.count_build_seconds = time.perf_counter() - t0
        return PSStreamState(
            host_topics=topics, d_blocks=d_blocks, server=server,
            clients=clients, clocks=np.full(S, int(clock), np.int64),
            cursors=np.zeros(S, np.int64), epochs=[None] * S)

    def init_state(self) -> PSStreamState:
        """The single-device initial draw (stream 0 over the padded token
        order), read at every worker's slots, and its counts."""
        full = esca.init_topics(
            uniforms_generator(self.cfg.seed, 0, self.device),
            (self.n_padded_tokens,), self.cfg.n_topics)
        topics = np.stack([
            full[gp.to(self.device, non_blocking=True)].cpu().numpy()
            for gp in self._gp])
        del full
        return self._make_state(topics, 0)

    # -- the worker round ----------------------------------------------------

    def _open_round(self, ss: PSStreamState, w: int) -> _PSEpochCarry:
        clock = int(ss.clocks[w])
        u = draw_uniforms(self.cfg.seed, clock, self.n_padded_tokens,
                          self.device)[
            self._gp[w].to(self.device, non_blocking=True)]
        u_host = torch.empty(u.shape, dtype=torch.float32,
                             pin_memory=self.device.type == "cuda")
        u_host.copy_(u)
        del u
        colsum = self._to_dev(ss.clients[w].pull_colsum())
        D = ss.d_blocks[w] if self.layout is None else \
            sparse.densify_rows_sorted(ss.d_blocks[w], self.cfg.n_topics)
        ep = _PSEpochCarry(u_host=u_host, colsum=colsum, D=D,
                           dD=torch.zeros_like(D),
                           start_topics=ss.host_topics[w].copy())
        ss.epochs[w] = ep
        return ep

    def _pull(self, client, base: int) -> torch.Tensor:
        """Page ``[base, base + page_rows)`` of the committed W on the
        card, through a pinned window."""
        page = client.pull_page(base, base + self.page_rows)
        self.io["pull_bytes"] += page.nbytes
        if self.device.type != "cuda":
            return torch.from_numpy(page)
        np.copyto(self._page_in.numpy(), page)
        return self._page_in.to(self.device)

    def _push(self, client, base: int, dw: torch.Tensor) -> None:
        self.io["push_bytes"] += dw.numel() * 4
        if self.device.type == "cuda":
            self._page_out.copy_(dw)
            dw = self._page_out
        client.push_page(base, base + self.page_rows, dw.numpy())

    def _sample_sub(self, ss: PSStreamState, w: int, r: int,
                    ep: _PSEpochCarry, page: torch.Tensor):
        """Worker ``w``'s sub-shard ``r`` against its round-start D block
        and the page: its moves into the D delta and a fresh page delta.
        Returns (new topics, page delta, branch counts, survivors)."""
        cfg, st = self.cfg, self.streams[w]
        c = st.cols(r)
        rel = self._to_dev(self._word_rel[w][c])
        doc = self._to_dev(st.doc_ids[c])
        mask = self._to_dev(st.mask[c])
        topics = self._to_dev(ss.host_topics[w, c])
        u = ep.u_host[c].to(self.device)
        W_hat = esca.compute_w_hat_from_colsum(page, ep.colsum, cfg.beta,
                                               n_words=self.n_words)
        stats_w = three_branch.word_stats(W_hat, g=cfg.g, alpha=cfg.alpha_)
        sparse_tail = None
        if self.layout is not None and cfg.tail_sampler == "sparse" \
                and self.pipe.n_tail:
            # the head/tail split keys on global word ids, Ŵ on the page's
            sparse_tail = (ss.d_blocks[w], self._to_dev(st.word_ids[c])
                           < self.layout.v_dense)
        dec, new_t, in_m, survivors = self.pipe._sample(
            u, rel, doc, ep.D, W_hat, stats_w, capacity=self.pipe.capacity,
            win_words=self.n_words, sparse_tail=sparse_tail)
        del W_hat, stats_w, sparse_tail
        dw = torch.zeros((self.page_rows, cfg.n_topics), dtype=torch.int32,
                         device=self.device)
        dcolsum = torch.zeros(cfg.n_topics, dtype=torch.int32,
                              device=self.device)
        scatter_changed_deltas(topics, new_t, doc, rel, mask, D=ep.dD, W=dw,
                               colsum=dcolsum)
        counts = _branch_counts(mask, dec.skip, in_m, new_t, topics, dec.k1)
        return new_t, dw, counts, sum(survivors.values())

    def _advance_worker(self, ss: PSStreamState, w: int,
                        max_subs: int | None = None) -> bool:
        """Run worker ``w`` forward by up to ``max_subs`` sub-shards
        (None = to the round close). Returns True iff the round closed."""
        R, L, io = self._R, self._L, self.io
        clock = int(ss.clocks[w])
        client = ss.clients[w]
        ep = ss.epochs[w] or self._open_round(ss, w)
        n_done = 0
        while int(ss.cursors[w]) < R and \
                (max_subs is None or n_done < max_subs):
            r = int(ss.cursors[w])
            if chaos.armed():
                chaos.shard_event(clock, w * R + r)
            base = int(self._bases[w, r])
            t0 = time.perf_counter()
            page = self._pull(client, base)
            t1 = time.perf_counter()
            new_t, dw, counts, n_surv = self._sample_sub(ss, w, r, ep, page)
            del page
            self._sync()
            t2 = time.perf_counter()
            self._push(client, base, dw)
            ss.host_topics[w, r * L:(r + 1) * L] = new_t.cpu().numpy()
            counts = counts.cpu().numpy()
            t3 = time.perf_counter()
            io["pull_s"] += t1 - t0
            io["sample_s"] += t2 - t1
            io["push_s"] += t3 - t2
            io["subs"] += 1
            ep.n_surv += float(n_surv)
            ep.stat_sums += counts[1:].astype(np.float64)
            ss.cursors[w] = r + 1
            n_done += 1
        if int(ss.cursors[w]) < R:
            return False
        # -- round close: fold the D delta, declare the round finished ----
        t0 = time.perf_counter()
        if self.layout is None:
            ss.d_blocks[w] += ep.dD
        else:
            ss.d_blocks[w], ov = sparse.pack_rows_sorted(
                ep.D + ep.dD, self.layout.d_capacity)
            ss.overflow += int(ov)
        acc = ss.stat_rounds.setdefault(
            clock, [0.0, np.zeros(4, np.float64)])
        acc[0] += ep.n_surv
        acc[1] = acc[1] + ep.stat_sums
        ss.epochs[w] = None
        ss.cursors[w] = 0
        ss.clocks[w] = clock + 1
        client.finish_round()        # may commit the round
        self._poll_owner_chaos(ss)
        io["commit_s"] += time.perf_counter() - t0
        io["rounds"] += 1
        return True

    def _poll_owner_chaos(self, ss: PSStreamState) -> None:
        """The owner-kill drill: wipe a planned owner at its planned
        committed round, then recover through the snapshot + journal
        replay path; the trajectory must come out bitwise unchanged."""
        if not chaos.armed():
            return
        srv = ss.server
        for o in range(srv.layout.n_owners):
            if chaos.ps_owner_event(o, srv.committed):
                srv.kill_owner(o)
                srv.revive_owner(o, [c.journal for c in ss.clients])

    # -- drivers -------------------------------------------------------------

    def step(self, state):
        raise ValueError(
            "the parameter-server trainer advances by whole rounds "
            "(epochs): use run_fused(state, n_iters)")

    def run_fused(self, ss: PSStreamState, n_iters: int):
        """Advance every worker ``n_iters`` rounds under the SSP clock.

        The scheduler picks, among workers behind the target whose pull
        the staleness gate admits, the one with the lowest ``clock +
        chaos bias``; each pick runs one whole round, so every pull
        within a round observes a single committed version. The slowest
        worker is always admissible (its clock equals the committed
        round), so progress is guaranteed; a chaos ``ps_slow_workers``
        bias skews the order, forcing the fast workers through genuinely
        stale (but admissible) pulls. Returns (state, stats stacked along
        a leading (n_iters,) axis)."""
        if chaos.armed():
            chaos.step_range(int(ss.iteration), int(n_iters))
        start = int(ss.iteration)
        target = start + int(n_iters)
        fplan = chaos.plan()
        bias = dict(fplan.ps_slow_workers) if fplan is not None else {}
        S = self.sc.n_shards
        while int(ss.clocks.min()) < target:
            cand = [w for w in range(S)
                    if int(ss.clocks[w]) < target
                    and ss.clients[w].can_advance()]
            w = min(cand, key=lambda i: (int(ss.clocks[i]) + bias.get(i, 0),
                                         i))
            self._advance_worker(ss, w)
        denom = float(max(int(self.sc.mask.sum()), 1))
        rows, surv = [], []
        for c in range(start, target):
            n_surv, sums = ss.stat_rounds.pop(c)
            rows.append(sums / denom)
            surv.append(n_surv)
        for c in [c for c in ss.stat_rounds if c < target]:
            del ss.stat_rounds[c]          # rounds reported by run_shards
        if surv:
            # the round's survivors plan the chunks, each at most a
            # sub-shard, as the streamed pipeline plans (no bit changes)
            self.pipe.note_survivors(torch.tensor(surv))
            self.pipe.capacity = min(self.pipe.capacity, self._L)
        m = torch.as_tensor(np.asarray(rows, np.float32).reshape(-1, 4))
        stats = three_branch.ThreeBranchStats(
            frac_skipped=m[:, 0], frac_m_final=m[:, 1],
            frac_unchanged=m[:, 2], frac_at_max=m[:, 3],
            frac_q_branch=torch.zeros(m.shape[0]))
        return ss, stats

    def run_shards(self, ss: PSStreamState, n_shards: int = 1):
        """Advance every worker ``n_shards`` sub-shards in lockstep: the
        mid-round stepping surface behind ``checkpoint_shards``. Lockstep
        keeps the clocks aligned, which is what makes the mid-round
        payload's cut canonical (``host_payload`` refuses skewed
        clocks)."""
        for _ in range(max(int(n_shards), 0)):
            for w in range(self.sc.n_shards):
                self._advance_worker(ss, w, max_subs=1)
        return ss

    # -- checkpointing -------------------------------------------------------

    def host_payload(self, ss: PSStreamState) -> dict:
        """The canonical payload at the aligned clock (the round-start
        topics of open rounds), with the ``ps_*`` keys mid-round. A
        durable checkpoint covers everything committed: the server
        snapshots its owner rows and the client journals are trimmed."""
        clocks = ss.clocks
        if int(clocks.max()) != int(clocks.min()):
            raise ValueError(
                "PS payloads cut at an aligned clock, but worker clocks "
                f"are skewed ({clocks.tolist()}): finish the round "
                "(run_fused) or step in lockstep (run_shards) first")
        cut = int(clocks[0])
        out = np.zeros(self.n_real_tokens, np.int32)
        for s in range(self.sc.n_shards):
            ep = ss.epochs[s]
            t = ep.start_topics if ep is not None else ss.host_topics[s]
            sel = self.sc.mask[s] > 0
            out[self.sc.global_pos[s][sel]] = t[:self._n_loc][sel]
        payload = {"topics_global": out, "key": key_data(self.cfg.seed),
                   "iteration": cut}
        if ss.cursors.any():
            payload.update(pack_ps_payload(
                server=ss.server, cursors=ss.cursors,
                done_topics=np.concatenate(
                    [ss.host_topics[w, :int(ss.cursors[w]) * self._L]
                     for w in range(self.sc.n_shards)]
                    or [np.zeros(0, np.int32)]),
                epochs=ss.epochs))
        ss.server.note_checkpoint(
            ss.server.committed, journals=[c.journal for c in ss.clients])
        return payload

    def state_from_payload(self, payload: dict) -> PSStreamState:
        """A state from a canonical payload of any engine (at its cut), or
        from this trainer's mid-round payload: the open rounds reopened,
        their D deltas and pushes re-derived from the done sub-shards'
        topics by the ``histogram`` kernel (counts are derived state)."""
        if int(np.asarray(payload.get("stream_cursor", 0))) > 0:
            raise ValueError(
                "mid-epoch single-host streaming checkpoints restore on "
                "the single-host backend only; the PS trainer resumes "
                "its own ps_* payloads or epoch-boundary payloads")
        tg = np.asarray(payload["topics_global"], np.int32)
        if tg.shape[0] != self.n_real_tokens:
            raise ValueError(
                f"checkpoint topics_global has {tg.shape[0]} entries but "
                f"the corpus holds {self.n_real_tokens} tokens: the "
                "checkpoint belongs to a different corpus")
        K = self.cfg.n_topics
        if tg.size and (tg.min() < 0 or tg.max() >= K):
            raise ValueError(f"checkpoint topics lie outside [0, {K})")
        # pads read token 0's topic: mask 0, so they count nowhere
        ss = self._make_state(
            np.stack([tg[st.global_pos] for st in self.streams]),
            int(payload["iteration"]))
        ext = unpack_ps_payload(payload)
        if ext is None or not ext.cursors.any():
            return ss
        # -- reopen the cut's partial rounds ---------------------------------
        # the stored owner rows are the committed W at the cut and must
        # equal the counts derived from the canonical topics
        if not np.array_equal(ext.gather_w(), ss.server.gather_global()):
            raise ValueError(
                "ps_* payload owner rows disagree with the counts "
                "derived from topics_global: corrupt checkpoint")
        L, P, off = self._L, self.page_rows, 0
        for w, st in enumerate(self.streams):
            cur = int(ext.cursors[w])
            if cur == 0:
                continue
            ep = self._open_round(ss, w)
            done = ext.done_topics[off:off + cur * L]
            off += cur * L
            ss.host_topics[w, :cur * L] = done
            ss.cursors[w] = cur
            client = ss.clients[w]
            for r in range(cur):
                c = st.cols(r)
                m = self._to_dev(st.mask[c])
                old = self._to_dev(ep.start_topics[c])
                new = self._to_dev(done[c])
                doc = self._to_dev(st.doc_ids[c])
                rel = self._to_dev(self._word_rel[w][c])
                ep.dD += self._count(doc, new, m, self.sc.m_local) \
                    - self._count(doc, old, m, self.sc.m_local)
                dw = self._count(rel, new, m, P) - self._count(rel, old, m, P)
                base = int(self._bases[w, r])
                client.push_page(base, base + P, dw.cpu().numpy())
            if ext.stat_sums is not None:
                ep.stat_sums = ext.stat_sums[w].copy()
                ep.n_surv = float(ext.n_surv[w])
        if off != ext.done_topics.shape[0]:
            raise ValueError(
                "ps_done_topics length disagrees with ps_cursors: "
                "corrupt checkpoint")
        return ss

    # -- introspection -------------------------------------------------------

    def dense_block(self, ss: PSStreamState, w: int) -> torch.Tensor:
        """Worker ``w``'s D block as dense int32 counts."""
        if self.layout is None:
            return ss.d_blocks[w]
        return sparse.densify_rows_sorted(ss.d_blocks[w], self.cfg.n_topics)

    def gather_global(self, ss: PSStreamState):
        """The global (D (M, K), W (V, K)) int32 counts at the committed
        cut, on the trainer's device."""
        K = self.cfg.n_topics
        D = torch.zeros((self.corpus.n_docs, K), dtype=torch.int32,
                        device=self.device)
        for s in range(self.sc.n_shards):
            nd = int(self.sc.docs_per_shard[s])
            D[self._to_dev(self.sc.doc_map[s][:nd])] = \
                self.dense_block(ss, s)[:nd]
        return D, self._to_dev(ss.server.gather_global())

    def state_nbytes(self, ss: PSStreamState) -> int:
        """Per-host live count bytes: the largest worker's D block plus
        the largest W owner shard (a host is at most one worker and one
        owner; no host keeps the whole W, the point of the design)."""
        d_bytes = max(int(b.numel()) * b.element_size()
                      for b in ss.d_blocks)
        return d_bytes + ss.server.max_owner_nbytes()

    def journal_nbytes(self, ss: PSStreamState) -> int:
        """Bytes the client push journals hold (until a checkpoint)."""
        return sum(c.journal.nbytes() for c in ss.clients)
