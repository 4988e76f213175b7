"""The port's serving tier (``src/repro_torch/serve``) against the
reference's (``src/repro/serve``), on the CPU.

* Bitwise against the reference on the same inputs made from a seed:
  ``head_rows_for_coverage``, ``pack_docs``, ``ServeConfig``'s validation
  (exception and message), ``LatencyHistogram`` percentiles, the
  ``ServeMetrics`` snapshot, and ``HotWordCache``'s local ids, hit
  accounting and tail assembly (the port assembles the reference's tail
  rows without the zero padding its jit signature needs).
* The tables, as the core and MH parity tests hold them: Ŵ, the top-(g+1)
  values and ids and the packed K1/K2 bitwise; Q' and ΣŴ (float32 sums of
  K terms in two orders) within rtol 1e-6; the alias tables bitwise on
  every row whose q the two packages sum to the same bits, the other rows
  counted.
* One replica sweep, fed the JAX sweep body's uniforms and previous topics
  (``tests/test_torch_serving.py``'s teacher forcing), draws the JAX
  topics on every real token but those within 1e-4 of the total mass of a
  CDF boundary, at most 1% of them; the batch D it rebuilds is the
  histogram of its topics.
* The port alone: a cached replica is bitwise a full-table one (θ and
  LLPT); a boundary refresh is bitwise a fresh freeze; the engine's
  ``subscribe``/``publish_serving`` surface on the single and the
  parameter-server backends; and the reference's service drills (reject
  after close, a replica killed mid-traffic, a slow replica, refresh
  during traffic, backpressure).
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mh as jmh
from repro.core import three_branch as jtb
from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.corpus import synthetic_lda_corpus
from repro.lda.model import LDAConfig as JaxConfig
from repro.lda.model import head_rows_for_coverage as j_head_rows
from repro.serve import HotWordCache as JaxCache
from repro.serve import LatencyHistogram as JaxHist
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeMetrics as JaxMetrics
from repro.serve.replicas import pack_docs as j_pack_docs
from repro_torch.core import mh
from repro_torch.lda.api import FrozenLDAModel, LDAEngine, SupervisePolicy
from repro_torch.lda.model import DistConfig, LDAConfig, head_rows_for_coverage
from repro_torch.runtime import chaos
from repro_torch.serve import (HotWordCache, LatencyHistogram, LDAService,
                               Replica, ReplicaDead, ServeConfig, ServeMetrics,
                               ServiceClosed, ServiceOverloaded,
                               ServingSnapshot, attach)
from repro_torch.serve.replicas import pack_docs
from _torch_parity import port_corpus

V, K = 40, 8
MARGIN = 1e-4


@pytest.fixture(scope="module")
def raw_corpus():
    return synthetic_lda_corpus(0, n_docs=50, n_words=V, n_topics=4,
                                mean_doc_len=14)


@pytest.fixture(scope="module")
def jax_model(raw_corpus):
    eng = JaxEngine(raw_corpus, JaxConfig(n_topics=K, tile_size=256),
                    backend="single")
    eng.fit(3)
    return eng.export()


@pytest.fixture(scope="module")
def model(jax_model):
    """The port's artifact of the same W (and word map)."""
    return FrozenLDAModel(W=np.asarray(jax_model.W), alpha=jax_model.alpha,
                          beta=jax_model.beta, g=jax_model.g,
                          word_map=jax_model.word_map,
                          tile_size=jax_model.tile_size, device="cpu")


@pytest.fixture(scope="module")
def qdocs():
    rng = np.random.default_rng(7)
    return [rng.integers(0, V, size=rng.integers(4, 20)).tolist()
            for _ in range(48)]


def small_cfg(**kw):
    base = dict(max_batch=16, buckets=(4, 8, 16), max_delay_ms=1.0,
                n_replicas=2, n_sweeps=2, token_floor=64, seed=0)
    base.update(kw)
    return ServeConfig(**base)


def _raised(fn):
    try:
        fn()
    except Exception as exc:        # noqa: BLE001 — compared below
        return type(exc).__name__, str(exc)
    return None


# ---------------------------------------------------------------------------
# bitwise against the reference
# ---------------------------------------------------------------------------

def test_head_rows_for_coverage_matches_reference():
    rng = np.random.default_rng(0)
    cases = [([5, 3, 1, 1], 0.8), ([5, 3, 1, 1], 1.0), ([0, 0], 0.9),
             ([], 0.5)]
    for _ in range(20):
        mass = np.sort(rng.zipf(1.3, rng.integers(1, 300)))[::-1]
        cases.append((mass, float(rng.uniform(0.05, 1.0))))
    for mass, cov in cases:
        assert head_rows_for_coverage(mass, cov) == j_head_rows(mass, cov)
    for bad in (0.0, 1.5, -0.1):
        assert _raised(lambda: head_rows_for_coverage([1, 1], bad)) == \
            _raised(lambda: j_head_rows([1, 1], bad))


def test_pack_docs_matches_reference(model):
    rng = np.random.default_rng(1)
    for trial in range(30):
        n = int(rng.integers(1, 40))
        docs = [rng.integers(0, V, size=rng.integers(0, 30)).tolist()
                for _ in range(n)]
        wm = model.word_map if trial % 2 else None
        kw = dict(n_words=V, word_map=wm, doc_buckets=(4, 8, 16),
                  token_floor=int(rng.choice([16, 64, 256])))
        got, want = pack_docs(docs, **kw), j_pack_docs(docs, **kw)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype
    kw = dict(n_words=V, word_map=None, doc_buckets=(4,), token_floor=16)
    for docs in ([[V + 3]], [[0], [-1]], []):
        assert _raised(lambda: pack_docs(docs, **kw)) == \
            _raised(lambda: j_pack_docs(docs, **kw))
    # a 20,480-token batch lands on a granule bucket, not a power of two
    big = [[1] * 20_480]
    assert pack_docs(big, **kw).word_ids.shape == \
        j_pack_docs(big, **kw).word_ids.shape == (20_480,)


@pytest.mark.parametrize("kw", [
    dict(buckets=(3, 8)), dict(buckets=(16, 8)), dict(buckets=()),
    dict(max_batch=64, buckets=(8, 16)), dict(hot_coverage=1.5),
    dict(hot_coverage=0.0), dict(hot_words=8, hot_coverage=0.8),
    dict(n_sweeps=0), dict(max_batch=0), dict(queue_limit=0),
    dict(max_delay_ms=-1.0), {}, dict(hot_coverage=0.9, n_replicas=3)])
def test_serve_config_validation_matches_reference(kw):
    assert _raised(lambda: ServeConfig(**kw)) == \
        _raised(lambda: JaxServeConfig(**kw))
    if _raised(lambda: ServeConfig(**kw)) is None:
        assert dataclasses.asdict(ServeConfig(**kw)) == \
            dataclasses.asdict(JaxServeConfig(**kw))


def test_latency_histogram_and_metrics_match_reference():
    rng = np.random.default_rng(2)
    samples = np.concatenate([rng.lognormal(-6, 1.5, 500), [0.0, 1e-7,
                                                           250.0, 0.5]])
    ports, refs = (LatencyHistogram(), LatencyHistogram(lo=1e-4, hi=10.0,
                                                        growth=1.2)), \
        (JaxHist(), JaxHist(lo=1e-4, hi=10.0, growth=1.2))
    for got, want in zip(ports, refs):
        assert got.snapshot_ms() == want.snapshot_ms()      # empty
        for s in samples:
            got.record(s)
            want.record(s)
        for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
            assert got.percentile(q) == want.percentile(q)
        assert got.snapshot_ms() == want.snapshot_ms()
    got, want = ServeMetrics(), JaxMetrics()
    assert got.snapshot() == want.snapshot()
    for m in (got, want):
        m.record_request(0.010)
        m.record_requests([0.002, 0.003, 0.5])
        m.record_batch(6, 8, 3)
        m.record_batch(16, 16, 40)
        m.record_cache(90, 10)
        m.record_rejected(2)
        m.record_failed()
        m.record_requeued_batch()
        m.record_refresh(0.25, 7)
    assert got.snapshot() == want.snapshot()


def _tail_rows_match(got_args, want_args, n):
    """The port's tail rows against the reference's first n (its padding
    aside), under the tolerances of the module docstring."""
    w_hat, a, k, k12, qp, ws, *alias = got_args
    jw, ja, jk, jk12, jqp, jws, *jalias = (np.asarray(x)[:n]
                                          for x in want_args)
    for x, y in ((w_hat, jw), (a, ja), (k, jk), (k12, jk12)):
        assert np.array_equal(x.numpy(), y)
    for x, y in ((qp, jqp), (ws, jws)):
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-6, atol=0)
    if alias:
        _alias_rows_match(w_hat.numpy(), alias, jalias)


def _alias_rows_match(w_hat, tables, jtables):
    """Against the reference's ``build_alias_tables`` of the same Ŵ rows
    (``tests/test_torch_mh.py``'s comparison): bitwise on every row whose
    q both packages sum to the same bits, the other rows counted. The
    reference cache builds its tables inside one jit, whose fused float
    operations may round prob in the last ulp: against those, prob within
    1e-5."""
    ref = jmh.build_alias_tables(jnp.asarray(w_hat))
    q_port = mh.proposal_weights(torch.from_numpy(w_hat))[0].numpy()
    same = np.all(q_port == np.asarray(ref.q), axis=1)
    for x, y in zip(tables, (ref.prob, ref.alias)):
        assert np.array_equal(x.numpy()[same], np.asarray(y)[same])
    assert 0 <= int((~same).sum()) <= w_hat.shape[0]   # counted
    np.testing.assert_allclose(tables[0].numpy(), np.asarray(jtables[0]),
                               rtol=0, atol=1e-5)


def test_cache_tables_match_reference(model, jax_model):
    H = 6
    got, want = HotWordCache(model, hot_words=H), JaxCache(jax_model,
                                                          hot_words=H)
    _tail_rows_match(got._state.hot.as_args(), want._state.hot.as_args(), H)
    full = HotWordCache(model)
    assert full.is_full and full._state.host_tail is None
    # the full tables are the frozen model's Ŵ and word stats
    assert torch.equal(full._state.hot.w_hat, model._w_hat)
    for x, y in zip(full._state.hot.stats, model._stats):
        assert torch.equal(x, y)


def test_cache_local_ids_and_tail_assembly_match_reference(model, jax_model,
                                                           qdocs):
    rng = np.random.default_rng(3)
    for H in (1, 6, 17, V - 1, V):
        got, want = HotWordCache(model, hot_words=H), \
            JaxCache(jax_model, hot_words=H)
        for _ in range(6):
            ids = rng.integers(0, V, size=rng.integers(1, 120))
            a, b = got.assemble(ids), want.assemble(ids)
            assert np.array_equal(a.local_ids, b.local_ids)
            assert a.local_ids.dtype == b.local_ids.dtype == np.int32
            assert (a.hits, a.misses) == (b.hits, b.misses)
            n_tail = a.n_rows - min(H, V)
            assert bool(a.tail_args) == bool(b.tail_args)
            if a.tail_args:
                assert n_tail == np.unique(ids[ids >= H]).size
                _tail_rows_match(a.tail_args, b.tail_args, n_tail)
            # the remapped ids index the same rows of the full tables
        assert (got.hits, got.misses, got.hit_rate) == \
            (want.hits, want.misses, want.hit_rate)


# ---------------------------------------------------------------------------
# one replica sweep against the JAX sweep body
# ---------------------------------------------------------------------------

def _jax_sweep(u, wid, did, msk, D, tables, n_docs, g, alpha, tile):
    """The reference's sweep body (``serve/replicas.py::_fold_in_fn``), on
    its assembled tables."""
    w_hat, a, k, k12, qp, ws = (jnp.asarray(np.asarray(x))
                                for x in tables[:6])
    stats_w = jtb.WordStats(a, k, k12, qp, ws)
    n = wid.shape[0]
    capacity = min(n, max(64, 1 << (max(n // 8, 1) - 1).bit_length()))
    n_chunks = max(1, -(-n // capacity))
    dec = jtb.skip_phase(u, wid, did, D, stats_w, g=g, alpha=alpha)
    rank, n_surv = jtb.survivor_rank(dec.skip)
    surv_idx = jtb.compact_survivor_indices(rank, dec.skip,
                                            n_chunks * capacity)

    def sample_chunk(idx):
        return jtb.exact_three_branch(u[idx], wid[idx], did[idx],
                                      stats_w.k[:, 0], D, w_hat,
                                      alpha=alpha, tile_size=tile)

    topics, _ = jtb.run_survivor_chunks(surv_idx, n_surv, dec.k1,
                                        capacity=capacity, n_chunks=n_chunks,
                                        sample_chunk=sample_chunk)
    D = jnp.zeros((n_docs, K), jnp.int32).at[did, topics].add(msk)
    return np.asarray(topics), D


def _margin(u, w_row, d_row, alpha):
    """float64 distance of the draw to its nearest CDF boundary, as a
    fraction of the total mass."""
    k1 = int(np.argmax(w_row))
    mass = np.where(np.arange(w_row.shape[0]) == k1, 0.0,
                    (d_row + alpha) * w_row)
    m = w_row[k1] * (d_row[k1] + alpha)
    cum = np.cumsum(mass)
    x = u * (m + cum[-1])
    return np.min(np.abs(x - np.concatenate([[m], m + cum]))) / (m + cum[-1])


@pytest.mark.parametrize("hot_words", [6, V])
def test_one_replica_sweep_matches_the_jax_sweep(model, jax_model, qdocs,
                                                 hot_words):
    """Teacher-forced: each sweep of the port's replica, fed the JAX
    sweep's uniforms and its previous topics, draws the JAX topics."""
    packed = pack_docs(qdocs[:16], n_words=V, word_map=model.word_map,
                       doc_buckets=(16,), token_floor=64)
    rep = Replica(0, model, hot_words=hot_words)
    asm = rep.cache.assemble(packed.word_ids)
    tables = rep.tables(asm)
    jasm = JaxCache(jax_model, hot_words=hot_words).assemble(packed.word_ids)
    jt = jasm.tables.as_args()
    jt = tuple(np.concatenate([np.asarray(h), np.asarray(t)])
               for h, t in zip(jt, jasm.tail_args)) if jasm.tail_args \
        else tuple(np.asarray(h) for h in jt)
    tb = rep.device_batch(packed, asm.local_ids)
    wid, did, msk = (jnp.asarray(a) for a in (asm.local_ids,
                                              packed.doc_ids, packed.mask))
    n, B, alpha = wid.shape[0], packed.n_docs, float(model.alpha)
    Wf = model.W.astype(np.float64)
    w_glob = (Wf + model.beta) / (Wf.sum(0) + V * model.beta)
    rng = np.random.default_rng(4)
    prev = rng.integers(0, K, n).astype(np.int32)
    bad = real = 0
    for s in range(3):
        u = np.array(jax.random.uniform(jax.random.PRNGKey(s), (n,),
                                        dtype=jnp.float32))
        Dj = jnp.zeros((B, K), jnp.int32).at[did, prev].add(msk)
        want, _ = _jax_sweep(jnp.asarray(u), wid, did, msk, Dj, jt, B,
                             model.g, alpha, model.tile_size)
        prev = np.array(prev)
        D0 = rep.counts(tb, torch.from_numpy(prev))
        assert np.array_equal(D0.numpy(), np.asarray(Dj))
        got, D, _ = rep.sweep(tb, tables, torch.from_numpy(u),
                              torch.from_numpy(prev), D0)
        got = got.numpy()
        Dw = np.zeros((B, K), np.int32)
        np.add.at(Dw, (packed.doc_ids, got), packed.mask)
        assert np.array_equal(D.numpy(), Dw)
        Dp = np.asarray(Dj, np.float64)
        for i in np.flatnonzero(packed.mask):
            if got[i] != want[i]:
                assert _margin(float(u[i]), w_glob[packed.word_ids[i]],
                               Dp[packed.doc_ids[i]], alpha) < MARGIN
                bad += 1
        real += int(packed.mask.sum())
        prev = want
    assert real >= 300 and bad <= real // 100, (bad, real)


# ---------------------------------------------------------------------------
# the port alone: cache, refresh, publish
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [True, False])
def test_cache_is_the_full_tables_bitwise(model, qdocs, warm):
    packed = pack_docs(qdocs[:8], n_words=V, word_map=model.word_map,
                       doc_buckets=(8,), token_floor=64)
    full = Replica(0, model, hot_words=V, warm_start=warm)
    for hot_words in (1, 6, 25):
        hot = Replica(1, model, hot_words=hot_words, warm_start=warm)
        for seed, seq in ((3, 0), (3, 5), (11, 2)):
            th_f, ll_f, acc_f = full.infer_packed(packed, seed, n_sweeps=3,
                                                  seq=seq)
            th_h, ll_h, acc_h = hot.infer_packed(packed, seed, n_sweeps=3,
                                                 seq=seq)
            assert np.array_equal(th_f, th_h) and ll_f == ll_h
            assert acc_f["cache_misses"] == 0 and acc_h["cache_misses"] > 0
            assert th_f.shape == (8, K) and np.isfinite(ll_f)
    assert full.cache.is_full and 0 < hot.cache.hit_rate < 1


def test_replica_refresh_and_kill(model, qdocs):
    cache = HotWordCache(model, hot_words=6)
    state0 = cache._state
    cache.refresh(np.asarray(model.W) + np.eye(V, K, dtype=np.int32))
    assert cache._state is not state0             # swapped, not mutated
    rep = Replica(0, model, hot_words=V)
    rep.kill()
    packed = pack_docs(qdocs[:2], n_words=V, word_map=model.word_map,
                       doc_buckets=(4,), token_floor=16)
    with pytest.raises(ReplicaDead):
        rep.infer_packed(packed, 0, n_sweeps=1)


def test_refresh_boundary_bitwise_equals_fresh_freeze(tmp_path, qdocs):
    """A service that followed the live trainer's publish stream answers,
    after the epoch-boundary swap, exactly as a service built from a
    freeze of the boundary snapshot; a replica refreshed to it exactly as
    a fresh one (θ and LLPT)."""
    corpus = synthetic_lda_corpus(1, n_docs=40, n_words=V, n_topics=4,
                                  mean_doc_len=12)
    eng = LDAEngine(port_corpus(corpus), LDAConfig(
        n_topics=K, tile_size=256, eval_every=50,
        corpus_residency="streamed", stream_shards=4), device="cpu",
        checkpoint_dir=str(tmp_path))
    eng.fit(1)
    svc = LDAService(eng.export(), small_cfg(n_replicas=1))
    snaps = []
    unsub = attach(eng, svc, on_snapshot=snaps.append)
    eng.fit(2, supervise=SupervisePolicy(checkpoint_shards=2))
    unsub()
    assert any(s.cursor > 0 for s in snaps), "no mid-epoch publish"
    assert [s.seq for s in snaps] == sorted(s.seq for s in snaps)
    mid = [s for s in snaps if s.cursor > 0][0]
    assert 0 < mid.staleness_steps < 1
    last = snaps[-1]
    assert last.cursor == 0 and np.array_equal(last.W, eng.export().W)
    assert svc.stats()["refreshes"] == len(snaps)
    th_refreshed = svc.transform(qdocs[:4], key=23, timeout=60)
    with LDAService(last.freeze("cpu"), small_cfg(n_replicas=1)) as ref:
        th_frozen = ref.transform(qdocs[:4], key=23, timeout=60)
    assert np.array_equal(th_refreshed, th_frozen)
    svc.close()
    packed = pack_docs(qdocs[:4], n_words=V, word_map=eng.word_map,
                       doc_buckets=(4,), token_floor=64)
    first = FrozenLDAModel(W=snaps[0].W, alpha=last.alpha, beta=last.beta,
                           g=last.g, word_map=eng.word_map, device="cpu")
    swapped = Replica(0, first, hot_words=6)
    swapped.refresh(np.asarray(last.W))
    fresh = Replica(1, last.freeze("cpu"), hot_words=6)
    a, b = (r.infer_packed(packed, 23, n_sweeps=2) for r in (swapped, fresh))
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]


def test_refresh_rejects_incompatible_and_stale(model):
    with LDAService(model, small_cfg()) as svc:
        good = ServingSnapshot(W=np.asarray(model.W), alpha=model.alpha,
                               beta=model.beta, g=model.g, iteration=1,
                               seq=1, word_map=model.word_map)
        assert svc.refresh(good) is True
        assert svc.refresh(good) is False         # same seq: stale
        with pytest.raises(ValueError, match="shape"):
            svc.refresh(dataclasses.replace(
                good, W=np.zeros((V + 1, K), np.int32), seq=2))
        with pytest.raises(ValueError, match="alpha"):
            svc.refresh(dataclasses.replace(good, alpha=model.alpha + 1.0,
                                            seq=3))
        assert svc.stats()["refreshes"] == 1


def test_engine_publish_subscribe_surface(raw_corpus):
    """Single and parameter-server backends: a snapshot at every chunk
    boundary of ``fit`` and one when it returns, ``publish_serving`` on
    demand, nothing after unsubscribing; ``from_engine`` and ``freeze``."""
    for cfg in (LDAConfig(n_topics=K, tile_size=256, eval_every=2,
                          fused=True),
                LDAConfig(n_topics=K, tile_size=256, eval_every=2,
                          fused=True, dist=DistConfig(
                              w_sync="ps", mesh_shape=(("data", 2),
                                                       ("model", 1))))):
        eng = LDAEngine(port_corpus(raw_corpus), cfg, device="cpu",
                        pad_multiple=64)
        seen = []
        unsub = eng.subscribe(seen.append)
        eng.fit(4)
        assert [s.iteration for s in seen] == [1, 2, 4, 4]
        assert all(s.cursor == 0 and s.staleness_steps == 0 for s in seen)
        assert np.array_equal(seen[-1].W, eng.export().W)
        snap = eng.publish_serving()
        assert seen[-1] is snap and snap.seq == 5
        unsub()
        eng.publish_serving()
        assert len(seen) == 5
        snap = ServingSnapshot.from_engine(eng, seq=9)
        assert snap.seq == 9 and np.array_equal(snap.W, eng.export().W)
        m = snap.freeze("cpu")
        assert m.n_words == V and m.n_topics == K


# ---------------------------------------------------------------------------
# the service and the reference's drills
# ---------------------------------------------------------------------------

def test_service_answers_stream(model, qdocs):
    with LDAService(model, small_cfg(hot_coverage=0.8)) as svc:
        assert svc.hot_words == head_rows_for_coverage(
            model.W.sum(axis=1), 0.8)
        assert svc.warmup() == 2
        futs = [svc.submit(d) for d in qdocs]
        single = svc.infer(qdocs[0], timeout=60)
        thetas = [f.result(timeout=60) for f in futs]
        for th in thetas + [single]:
            assert th.shape == (K,) and np.all(np.isfinite(th))
            assert abs(float(th.sum()) - 1.0) < 1e-4
        st = svc.stats()
        assert st["completed"] == len(qdocs) + 1
        assert st["failed"] == 0 and st["rejected"] == 0
        assert st["batches"] >= 1 and 0 < st["batch_fill"] <= 1
        assert 0 < st["cache_hit_rate"] <= 1
        assert st["latency"]["n"] == len(qdocs) + 1
        assert st["latency"]["p50_ms"] <= st["latency"]["p99_ms"]
        assert st["alive_replicas"] == 2


def test_service_rejects_after_close(model, qdocs):
    svc = LDAService(model, small_cfg())
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(qdocs[0])
    with pytest.raises(ServiceClosed):
        svc.submit_batch(qdocs[:2])
    svc.close()                                   # a second close: no-op


def test_transform_deterministic_under_pinned_key(model, qdocs):
    with LDAService(model, small_cfg()) as svc:
        a = svc.transform(qdocs[:6], key=11, timeout=60)
        b = svc.transform(qdocs[:6], key=11, timeout=60)
    with LDAService(model, small_cfg(hot_coverage=0.5)) as svc2:
        c = svc2.transform(qdocs[:6], key=11, timeout=60)
    assert np.array_equal(a, b) and np.array_equal(a, c)


def test_chaos_replica_kill_mid_request_completes_all(model, qdocs):
    with LDAService(model, small_cfg(n_replicas=2)) as svc:
        svc.infer(qdocs[0], timeout=60)
        # replica 1 sleeps on its first batch, so replica 0 surely picks
        # one of the (at least three) batches while the plan is armed
        with chaos.active(chaos.FaultPlan(kill_replicas=(0,),
                                          slow_replicas={1: 0.3})):
            futs = [svc.submit(d) for d in qdocs]
            thetas = [f.result(timeout=60) for f in futs]
        assert all(t.shape == (K,) for t in thetas)
        st = svc.stats()
        assert st["alive_replicas"] == 1           # the kill landed
        assert st["requeued_batches"] >= 1         # its batch re-queued
        assert st["failed"] == 0                   # the survivor answered


def test_chaos_slow_replica_delays_only_its_own_batch(model, qdocs):
    with LDAService(model, small_cfg(n_replicas=2)) as svc:
        groups = [qdocs[i * 4:(i + 1) * 4] for i in range(6)]
        for g in groups:
            for f in svc.submit_batch(g):
                f.result(timeout=60)
        done: dict[int, float] = {}
        lock = threading.Lock()
        with chaos.active(chaos.FaultPlan(slow_replicas={0: 0.8})):
            t0 = time.perf_counter()

            def arm(i, futs):
                left = [len(futs)]

                def cb(_):
                    with lock:
                        left[0] -= 1
                        if left[0] == 0:
                            done[i] = time.perf_counter() - t0
                for f in futs:
                    f.add_done_callback(cb)

            batches = [svc.submit_batch(g) for g in groups]
            for i, futs in enumerate(batches):
                arm(i, futs)
            for futs in batches:
                for f in futs:
                    f.result(timeout=60)
        slow = [t for t in done.values() if t >= 0.8]
        fast = [t for t in done.values() if t < 0.5]
        assert len(slow) == 1 and len(fast) == len(done) - 1
        assert svc.stats()["failed"] == 0


def test_chaos_refresh_during_traffic_never_tears(model, qdocs):
    W0 = np.asarray(model.W, np.int32)
    W1 = W0 + np.ones_like(W0)
    with LDAService(model, small_cfg(n_replicas=2)) as svc:
        stop = threading.Event()
        errs: list[Exception] = []

        def refresher():
            seq = 1
            while not stop.is_set():
                try:
                    svc.refresh(ServingSnapshot(
                        W=W0 if seq % 2 == 0 else W1, alpha=model.alpha,
                        beta=model.beta, g=model.g, iteration=0, seq=seq))
                except Exception as e:        # noqa: BLE001 — never expected
                    errs.append(e)
                    return
                seq += 1

        th = threading.Thread(target=refresher)
        th.start()
        try:
            for _ in range(10):
                for f in [svc.submit(d) for d in qdocs[:16]]:
                    assert np.all(np.isfinite(f.result(timeout=60)))
        finally:
            stop.set()
            th.join()
        assert not errs
        st = svc.stats()
        assert st["failed"] == 0 and st["refreshes"] >= 2
        svc.refresh(ServingSnapshot(W=W1, alpha=model.alpha,
                                    beta=model.beta, g=model.g,
                                    iteration=0, seq=10 ** 6))
        got = svc.transform(qdocs[:4], key=5, timeout=60)
    m1 = FrozenLDAModel(W=W1, alpha=model.alpha, beta=model.beta, g=model.g,
                        word_map=model.word_map, device="cpu")
    with LDAService(m1, small_cfg(n_replicas=2)) as ref:
        want = ref.transform(qdocs[:4], key=5, timeout=60)
    assert np.array_equal(got, want)


def test_backpressure_sheds_load_when_saturated(model, qdocs):
    cfg = small_cfg(n_replicas=1, queue_limit=4, max_delay_ms=0.5)
    with LDAService(model, cfg) as svc:
        svc.infer(qdocs[0], timeout=60)
        with chaos.active(chaos.FaultPlan(slow_replicas={0: 1.0})):
            saw_overload = False
            futs = []
            for i in range(200):
                try:
                    futs.append(svc.submit(qdocs[i % len(qdocs)]))
                except ServiceOverloaded:
                    saw_overload = True
                    break
                time.sleep(0.002)
            assert saw_overload, "bounded queue never shed load"
            for f in futs:
                f.result(timeout=60)
        assert svc.stats()["rejected"] >= 1
