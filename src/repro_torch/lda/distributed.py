"""Multi-GPU EZLDA (paper §V-B) and the topic-axis split, on
``torch.distributed``.

Port of the resident, replicated part of ``src/repro/lda/distributed.py``
(``w_sync="replicate"``). The reference runs one SPMD program under
``shard_map`` over a device mesh; the port runs one process per rank, as
``torchrun`` starts them, over a ``runtime/sharding.py::ProcessMesh``:

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

Not yet ported (ROADMAP.md Queue 1 #12, second part): streamed residency
on this trainer, the parameter server (``w_sync="ps"``), and the
supervised fit on the distributed backend.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import balance as balance_mod
from repro_torch.core import esca, sparse, three_branch
from repro_torch.core import llpt as llpt_mod
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels.ref import histogram_ref
from repro_torch.lda import invariants
from repro_torch.lda.convert import key_data
from repro_torch.lda.corpus import Corpus, chunk_documents, pad_corpus
from repro_torch.lda.model import LDAConfig, uniforms_generator
from repro_torch.runtime import chaos
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.sharding import ProcessMesh, batch_axes, \
    mesh_axis_size
from repro_torch.train.lda_step import (FusedPipeline, HybridFusedPipeline,
                                        draw_uniforms, repack_counts,
                                        resolve_residency)

__all__ = ["ShardedCorpus", "shard_corpus", "DistLDAState",
           "DistHybridState", "DistLDATrainer"]

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
# the trainer
# ---------------------------------------------------------------------------

def _streamed_unported() -> NotImplementedError:
    return NotImplementedError(
        "corpus_residency='streamed' on the distributed backend is not "
        "ported yet: it arrives with ROADMAP.md Queue 1 #12 (second part: "
        "streamed distributed residency); use corpus_residency='full', or "
        "backend='single' to stream")


class DistLDATrainer:
    """One rank of the replicated multi-GPU EZLDA trainer.

    ``mesh`` must carry a ``model`` axis (size 1 reproduces the paper's
    pure data-parallel scheme) plus ``data`` (and optionally ``pod``);
    data shards = the data axes' extent, and K must divide by the model
    axis. Every rank of the mesh constructs its trainer and calls every
    method in the same order: most of them run collectives.

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
        if config.corpus_residency == "streamed":
            raise _streamed_unported()
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
        if resolve_residency(config, int(self.sc.word_ids.shape[1]),
                             self.device)[0] != "full":
            raise _streamed_unported()
        # this rank's data shard: row-major over the data axes, as
        # P(("pod", "data")) splits the reference's leading shard axis
        self.shard = int(np.ravel_multi_index(
            [mesh.axis_index(a) for a in self.data_axes],
            [mesh.shape[a] for a in self.data_axes])) \
            if self.data_axes else 0
        s, sc = self.shard, self.sc
        to_dev = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(self.device)
        self.word_ids = to_dev(sc.word_ids[s])
        self.doc_ids = to_dev(sc.doc_ids[s])
        self.mask = to_dev(sc.mask[s])
        self.global_pos = to_dev(sc.global_pos[s])
        self.n_docs_local = int(sc.docs_per_shard[s])
        self.shared_slot = self.shared_rows = None
        self.n_shared = 0
        if sc.shared_slot is not None:
            self.shared_slot = to_dev(sc.shared_slot[s])
            self.shared_rows = to_dev(sc.shared_rows[s])
            self.n_shared = int(sc.shared_rows.shape[1])
        self.pipe = None
        self.layout = None
        if self.pm == 1:
            kw = dict(n_docs=sc.m_local, n_words=self.n_words, config=config)
            if config.format == "hybrid":
                self.pipe = HybridFusedPipeline(
                    self.word_ids, self.doc_ids, self.mask, corpus=corpus,
                    **kw)
                self.layout = self.pipe.layout
            else:
                self.pipe = FusedPipeline(self.word_ids, self.doc_ids,
                                          self.mask, **kw)
        # dW (V rows), Δcolsum (1 row) and the shared rows' ΔD (n_shared
        # rows): one buffer, one all-reduce an iteration
        self._delta = torch.zeros(
            (self.n_words + 1 + self.n_shared, self.k_local),
            dtype=torch.int32, device=self.device)
        self._eval = None
        self.count_build_seconds = None
        # tokens a chunk of the topic-split sweep (results are per token)
        self.sweep_tokens = max(1024, SWEEP_CHUNK_BYTES // (4 * self.k_local))

    # -- counts --------------------------------------------------------------

    def _count(self, rows, topics, weights, n_rows: int) -> torch.Tensor:
        """(n_rows, K_loc) counts of this rank's tokens (the topics of this
        block; others add nothing): the ``histogram`` kernel's any-order
        route with ``impl="kernel"``, its plain twin with ``"torch"``."""
        fn = _hist.histogram if self.cfg.impl == "kernel" else histogram_ref
        return fn(rows, topics - self.kb0 if self.kb0 else topics, weights,
                  n_rows=n_rows, n_topics=self.k_local)

    def _state_from_topics(self, topics: torch.Tensor, iteration: int):
        """Counts of this rank's topics, built on its device: local D and
        W, W summed over the data axes, the shared rows' D too."""
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        D = self._count(self.doc_ids, topics, self.mask, self.sc.m_local)
        W = self._count(self.word_ids, topics, self.mask, self.n_words)
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
        state = DistLDAState(topics=topics, D=D, W=W, colsum=colsum,
                             iteration=int(iteration))
        return self._pack(state) if self.layout is not None else state

    def _pack(self, st: DistLDAState) -> DistHybridState:
        w_head, w_tail = self.layout.split_w(st.W)
        return DistHybridState(
            topics=st.topics, D=self.layout.pack_d(st.D), W_head=w_head,
            W_tail=w_tail, colsum=st.colsum,
            overflow=torch.zeros((), dtype=torch.int32, device=self.device),
            iteration=st.iteration)

    def init_state(self):
        """The single-device initial draw (stream 0 over the padded token
        order), read at this rank's slots, and its counts."""
        full = esca.init_topics(
            uniforms_generator(self.cfg.seed, 0, self.device),
            (self.n_padded_tokens,), self.cfg.n_topics)
        return self._state_from_topics(full[self.global_pos], 0)

    def _uniforms(self, iteration: int) -> torch.Tensor:
        """Iteration ``iteration``'s single-device uniforms at this rank's
        slots (pads read token 0's: their moves are masked out)."""
        return draw_uniforms(self.cfg.seed, iteration, self.n_padded_tokens,
                             self.device)[self.global_pos]

    # -- the iteration --------------------------------------------------------

    def _moves(self, topics, new_topics) -> _Moves:
        idx = ((new_topics != topics) & (self.mask > 0)).nonzero().squeeze(1)
        return _Moves(idx, topics[idx], new_topics[idx])

    def _scatter_local(self, D: torch.Tensor, mv: _Moves) -> None:
        """±1 moves into this rank's D rows, in place."""
        if self.pm == 1:
            esca.scatter_moves(D, self.doc_ids[mv.idx], mv.old, mv.new)
        else:
            self._scatter_block(D, self.doc_ids[mv.idx], mv)

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

    def _scatter_deltas(self, mv: _Moves) -> torch.Tensor:
        """The iteration's delta buffer: dW, Δcolsum and the shared rows'
        ΔD of this rank's moves, zero-filled first."""
        buf = self._delta
        buf.zero_()
        V = self.n_words
        parts = [(buf[:V], self.word_ids[mv.idx]), (buf[V], None)]
        if self.n_shared:
            # tokens of documents held by this shard alone carry the
            # sentinel slot n_shared: no shared row takes their moves
            slot = self.shared_slot[mv.idx]
            keep = slot < self.n_shared
            sub = _Moves(mv.idx[keep], mv.old[keep], mv.new[keep])
            rows = buf[V + 1:]
            if self.pm == 1:
                esca.scatter_moves(rows, slot[keep], sub.old, sub.new)
            else:
                self._scatter_block(rows, slot[keep], sub)
        for counts, rows in parts:
            if self.pm == 1:
                esca.scatter_moves(counts, rows, mv.old, mv.new)
            else:
                self._scatter_block(counts, rows, mv)
        return buf

    def _apply_deltas(self, D, W, colsum, mv: _Moves) -> None:
        """Local ±1 into D; dW (and the shared rows' ΔD) summed over the
        data axes and added to every replica: the paper's
        sum-and-broadcast."""
        self._scatter_local(D, mv)
        buf = self._scatter_deltas(mv)
        V = self.n_words
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

    def _stats(self, skip, in_m, new_topics, topics, k1):
        """The reference's branch statistics: masked means over the real
        tokens of every data shard, summed as exact int64 counts."""
        real = self.mask > 0
        counts = torch.stack([
            real.sum(), (skip & real).sum(), ((skip | in_m) & real).sum(),
            ((new_topics == topics) & real).sum(),
            ((new_topics == k1) & real).sum()]).to(torch.int64)
        self.mesh.psum(counts, self.data_axes)
        f = (counts[1:].double() / counts[0].clamp(min=1)).float()
        return three_branch.ThreeBranchStats(
            frac_skipped=f[0], frac_m_final=f[1], frac_unchanged=f[2],
            frac_at_max=f[3], frac_q_branch=torch.zeros((), device=f.device))

    def _step_replicated(self, st, u):
        """Model axis 1: the port's resident sampler body over this rank's
        tokens, dense or hybrid."""
        cfg, pipe = self.cfg, self.pipe
        hybrid = self.layout is not None
        if hybrid:
            topics, d_packed, w_head, w_tail, colsum, overflow, it = st
            D = sparse.densify_rows_sorted(d_packed, cfg.n_topics)
            W = self.layout.densify_w(w_head, w_tail)
            sparse_tail = (d_packed, pipe.head_mask) \
                if cfg.tail_sampler == "sparse" and pipe.n_tail else None
        else:
            topics, D, W, colsum, it = st
            sparse_tail = None
        W_hat = esca.compute_w_hat_from_colsum(W, colsum, cfg.beta)
        stats_w = three_branch.word_stats(W_hat, g=cfg.g, alpha=cfg.alpha_)
        dec, new_topics, in_m, survivors = pipe._sample(
            u, self.word_ids, self.doc_ids, D, W_hat, stats_w,
            capacity=pipe.capacity, win_words=pipe.win_words,
            sparse_tail=sparse_tail)
        del W_hat, stats_w, sparse_tail
        if hybrid:
            pipe.last_survivors = survivors
        stats = self._stats(dec.skip, in_m, new_topics, topics, dec.k1)
        self._apply_deltas(D, W, colsum, self._moves(topics, new_topics))
        n_surv = sum(survivors.values()) if hybrid else survivors["head"]
        if not hybrid:
            return DistLDAState(topics=new_topics, D=D, W=W, colsum=colsum,
                                iteration=it + 1), stats, n_surv
        d_packed, w_head, w_tail, overflow = repack_counts(
            self.layout, D, W, overflow)
        return DistHybridState(
            topics=new_topics, D=d_packed, W_head=w_head, W_tail=w_tail,
            colsum=colsum, overflow=overflow, iteration=it + 1), stats, n_surv

    def _step_split(self, st: DistLDAState, u):
        """Model axis > 1: the reference's two-level inverse CDF, chunk by
        chunk of tokens against the iteration-start counts."""
        cfg, mesh = self.cfg, self.mesh
        topics, D, W, colsum, it = st
        W_hat, g_vals, g_idx, q_prime = _word_phase(
            W, colsum, mesh, beta=cfg.beta, alpha=cfg.alpha_,
            n_words=self.n_words, g=cfg.g, kb0=self.kb0,
            k_local=self.k_local)
        len_tot = mesh.psum(D.sum(dim=-1, dtype=torch.float32), "model")
        n = topics.shape[0]
        new_topics = torch.empty_like(topics)
        skip = torch.empty(n, dtype=torch.bool, device=self.device)
        in_m = torch.empty_like(skip)
        k1 = torch.empty_like(topics)
        step = self.sweep_tokens
        for lo in range(0, n, step):
            sl = slice(lo, min(lo + step, n))
            doc = self.doc_ids[sl]
            out = _token_sweep(
                u[sl], self.word_ids[sl], doc, D[doc.long()], len_tot,
                W_hat, g_vals, g_idx, q_prime, mesh, alpha=cfg.alpha_,
                g=cfg.g, kb0=self.kb0, k_local=self.k_local)
            new_topics[sl], skip[sl], in_m[sl], k1[sl] = out
        del W_hat, g_vals, g_idx, q_prime, len_tot
        stats = self._stats(skip, in_m, new_topics, topics, k1)
        n_surv = int((~skip & (self.mask > 0)).sum())
        self._apply_deltas(D, W, colsum, self._moves(topics, new_topics))
        return DistLDAState(topics=new_topics, D=D, W=W, colsum=colsum,
                            iteration=it + 1), stats, n_surv

    def _step(self, state):
        u = self._uniforms(int(state.iteration))
        if self.pm == 1:
            return self._step_replicated(state, u)
        return self._step_split(state, u)

    def step(self, state):
        """One iteration: (state, stats). Updates ``state``'s count
        tensors in place."""
        state, stats, _ = self._step(state)
        return state, stats

    def run_fused(self, state, n_iters: int):
        """``n_iters`` iterations: (state, stats stacked along a leading
        (n_iters,) axis). The survivor counts re-plan the sampler's chunk
        capacity (and the tiles' window) for the next call, as the
        single-device pipeline's ``run_fused`` does."""
        if chaos.armed():
            chaos.step_range(int(state.iteration), int(n_iters))
        stats, n_surv, spans = [], [], []
        for _ in range(int(n_iters)):
            state, st, ns = self._step(state)
            stats.append(st)
            n_surv.append(ns)
            if self.pipe is not None:
                spans.append(self.pipe.last_span)
        kind = three_branch.ThreeBranchStats
        stacked = kind(*(torch.stack([torch.as_tensor(getattr(s, f))
                                      for s in stats]) if stats
                         else torch.zeros(0) for f in kind._fields))
        if self.pipe is not None and stats:
            self.pipe.note_survivors(torch.tensor(n_surv))
            if self.pipe.balance == "tiles":
                self.pipe.note_spans(spans)
        return state, stacked

    # -- checkpoints (global token order: elastic across meshes) --------------

    def host_payload(self, state) -> dict:
        """The canonical payload: ``topics_global`` assembled by one sum of
        a zero (N,) buffer over the data axes with each rank's real slots
        written, the key data and the iteration (on every rank)."""
        real = self.mask > 0
        out = torch.zeros(self.n_real_tokens, dtype=torch.int32,
                          device=self.device)
        out[self.global_pos[real]] = state.topics[real]
        self.mesh.psum(out, self.data_axes)
        return {"topics_global": out.cpu().numpy(),
                "key": key_data(self.cfg.seed),
                "iteration": int(state.iteration)}

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
        full = torch.from_numpy(tg).to(self.device)
        # pads read token 0's topic: mask 0, so they count nowhere
        return self._state_from_topics(full[self.global_pos],
                                       int(payload["iteration"]))

    # -- global views ---------------------------------------------------------

    def dense_rows(self, state) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's (D rows, W replica) as dense int32 blocks."""
        if self.layout is None:
            return state.D, state.W
        lay = self.layout
        return (sparse.densify_rows_sorted(state.D, lay.n_topics),
                lay.densify_w(state.W_head, state.W_tail))

    def gather_global(self, state) -> tuple[torch.Tensor, torch.Tensor]:
        """The global (D (M, K), W (V, K)) int32 count matrices on this
        rank's device: each document counted once, through its gather
        owner under tiles (a collective: every rank calls it)."""
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

    def eval_arrays(self):
        """The single engine's padded token arrays on this rank's device
        (built once): the LLPT runs over the same tiles as there."""
        if self._eval is None:
            padded, mask = pad_corpus(self.corpus, self.cfg.tile_size)
            self._eval = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                    self.device)
                for a in (padded.word_ids, padded.doc_ids, mask))
        return self._eval

    def evaluate(self, state) -> float:
        """Training LLPT from the gathered global counts over the single
        engine's padded corpus arrays: bitwise the single engine's."""
        D, W = self.gather_global(state)
        word_ids, doc_ids, mask = self.eval_arrays()
        score = float(llpt_mod.llpt(word_ids, doc_ids, mask, D, W,
                                    alpha=self.cfg.alpha_,
                                    beta=self.cfg.beta,
                                    tile_size=self.cfg.tile_size))
        if self.cfg.selfcheck and not np.isfinite(score):
            raise invariants.InvariantViolation(
                "finite_llpt", f"evaluate (iteration "
                f"{int(state.iteration)})", f"llpt={score!r}")
        return score

    def state_nbytes(self, state) -> int:
        """Live count-state bytes on this rank: its D rows, its W replica
        (packed for the hybrid format) and the column sum."""
        if self.layout is None:
            parts = [state.D, state.W, state.colsum]
        else:
            parts = [state.D, state.W_head, *state.W_tail, state.colsum]
        return int(sum(t.numel() for t in parts)) * 4

    def selfcheck(self, state) -> None:
        """Count-invariant tripwire on the gathered global counts
        (``config.selfcheck``; a gather per chunk boundary)."""
        D, W = self.gather_global(state)
        invariants.check_dense_counts(
            D, W, n_tokens=self.n_real_tokens,
            where=f"distributed chunk boundary (iteration "
                  f"{int(state.iteration)})")
