"""Streamed and disk-native residency: the port against itself and against
the reference.

Inside the port, bitwise: streamed == resident and disk == streamed ==
resident (topics, D, W and every LLPT) over the dense path, the hybrid
path and the paper's configuration; the shard count changes no bit; a
mid-epoch checkpoint resumes bit for bit. Against the reference: the
planners agree on a table of inputs; a mid-epoch payload of either
package restores to counts and deltas bitwise the reference's; one
streamed epoch handed the reference's uniforms matches the reference's
streamed epoch under ``tests/_torch_parity.py``'s tolerance. The
prefetcher retries, times out and closes quietly.
"""

import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.lda.model import LDAConfig as JaxConfig
from repro.lda.trainer import LDATrainer as JaxTrainer
from repro.train import lda_step as jax_step
from repro_torch.core import esca
from repro_torch.lda import LDAConfig, LDAEngine, LDATrainer
from repro_torch.lda.corpus import shard_stream
from repro_torch.train import lda_step
from repro_torch.train.lda_step import (PrefetchTimeout, StreamState,
                                        _Prefetcher)
from _torch_parity import assert_topics_agree, port_corpus

KW = dict(n_topics=16, tile_size=512)
PATHS = [dict(), dict(format="hybrid"),
         dict(format="hybrid", tail_sampler="sparse", balance="tiles"),
         dict(balance="tiles"), dict(impl="torch")]
PATH_IDS = ["dense", "hybrid", "paper", "dense_tiles", "dense_torch"]


@pytest.fixture(scope="module")
def corpus(small_corpus):
    return port_corpus(small_corpus)


def _streamed(**kw):
    return LDAConfig(corpus_residency="streamed", stream_shards=4, **KW,
                     **kw)


def _store(corpus, tmp_path, n_shards=4, name="store"):
    return shard_stream(corpus, n_shards, multiple=KW["tile_size"]).to_store(
        str(tmp_path / name))


def _disk(store, **kw):
    return LDAConfig(corpus_residency="disk", corpus_path=store.path, **KW,
                     **kw)


def _same(a, b, n_padded):
    """Padded topics, D and W of two dense states, bitwise."""
    return (torch.equal(a.topics[:n_padded], b.topics[:n_padded])
            and torch.equal(a.D, b.D) and torch.equal(a.W, b.W)
            and int(a.iteration) == int(b.iteration))


# ---------------------------------------------------------------------------
# streamed == disk == resident, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", PATHS, ids=PATH_IDS)
def test_disk_equals_streamed_equals_resident(corpus, extra, tmp_path):
    kw = dict(eval_every=2, fused=True, **extra)
    res = LDAEngine(corpus, LDAConfig(**KW, **kw), device="cpu")
    h_res = res.fit(4)
    st = LDAEngine(corpus, _streamed(**kw), device="cpu")
    assert st.trainer.residency == "streamed" and st.trainer.word_ids is None
    h_st = st.fit(4)
    dk = LDAEngine(None, _disk(_store(res.corpus, tmp_path), **kw),
                   device="cpu")
    assert dk.trainer.residency == "disk"
    assert dk.trainer.fused_pipeline().paged
    h_dk = dk.fit(4)
    assert isinstance(dk.state, StreamState)
    n = res.trainer.n_padded_tokens
    assert _same(res.state, st.state, n)
    assert _same(res.state, dk.trainer.fused_pipeline().to_lda_state(
        dk.state), n)
    assert h_res["llpt"] == h_st["llpt"] == h_dk["llpt"]
    assert h_res["iteration"] == h_st["iteration"] == h_dk["iteration"]
    assert res.score() == st.score() == dk.score()
    pays = [e.host_payload() for e in (res, st, dk)]
    for p in pays[1:]:
        assert sorted(p) == ["iteration", "key", "topics_global"]
        assert np.array_equal(p["topics_global"], pays[0]["topics_global"])
        assert np.array_equal(p["key"], pays[0]["key"])
    assert np.array_equal(res.top_words(5), dk.top_words(5))
    assert np.array_equal(res.export().W, dk.export().W)


@pytest.mark.parametrize("extra", PATHS[:3], ids=PATH_IDS[:3])
def test_shard_count_is_a_pure_perf_knob(corpus, extra):
    outs = []
    for shards in (2, 3, 7):
        tr = LDATrainer(corpus, LDAConfig(
            corpus_residency="streamed", stream_shards=shards, **KW,
            **extra), device="cpu")
        pipe = tr.fused_pipeline()
        ss, stats, n_surv = pipe.run_fused(tr.init_state(), 3)
        assert tuple(n_surv.shape) == (3,) and (n_surv > 0).all()
        assert tuple(stats.frac_skipped.shape) == (3,)
        outs.append(pipe.to_lda_state(ss))
    n = outs[0].topics.shape[0]
    assert _same(outs[0], outs[1], n) and _same(outs[1], outs[2], n)


def test_streamed_stats_are_the_resident_fractions(corpus):
    res = LDATrainer(corpus, LDAConfig(**KW), device="cpu")
    pr = res.fused_pipeline()
    _, st_r, ns_r = pr.run_fused(pr.from_lda_state(res.init_state()), 2)
    tr = LDATrainer(corpus, _streamed(), device="cpu")
    _, st_s, ns_s = tr.fused_pipeline().run_fused(tr.init_state(), 2)
    assert torch.equal(ns_r.long(), ns_s)
    for f in ("frac_skipped", "frac_m_final", "frac_unchanged",
              "frac_at_max"):
        assert torch.allclose(getattr(st_r, f), getattr(st_s, f),
                              atol=1e-6), f


def test_disk_llpt_equals_resident_llpt_exactly(corpus, tmp_path):
    res = LDAEngine(corpus, LDAConfig(fused=True, eval_every=5, **KW),
                    device="cpu")
    res.fit(3)
    dk = LDAEngine(None, _disk(_store(res.corpus, tmp_path, n_shards=3),
                               fused=True, eval_every=5), device="cpu")
    dk.fit(3)
    assert res.score() == dk.score()
    # a resident state scored by a streamed trainer: the same bits
    st = LDATrainer(corpus, _streamed(), device="cpu")
    assert st.evaluate(res.state) == res.score()


def test_disk_pages_w_per_shard(corpus, tmp_path):
    store = _store(corpus, tmp_path, n_shards=8)
    tr = LDATrainer(None, _disk(store), device="cpu")
    pipe = tr.fused_pipeline()
    spans = np.maximum(store.last_word.astype(np.int64)
                       - store.first_word + 1, 1)
    assert pipe.page_rows == min(max(int(spans.max()),
                                     lda_step.PAGE_ROWS_FLOOR),
                                 store.n_words)
    for s in range(store.n_shards):         # every run fits its window
        if store.real_per_shard[s]:
            b = int(pipe.page_base[s])
            assert b <= store.first_word[s]
            assert store.last_word[s] < b + pipe.page_rows
    ss, _, _ = pipe.run_fused(tr.init_state(), 1)
    assert len(ss.counts) == 2 and ss.pages.w.shape == (store.n_words, 16)
    assert pipe.last_epoch_device_bytes > 0
    assert pipe.last_epoch_io["epoch_s"] > 0
    assert len(pipe.last_epoch_io["shard_s"]) == store.n_shards
    W, cursor, n_sh = pipe.serving_counts(ss)
    assert cursor == 0 and n_sh == store.n_shards
    assert np.array_equal(W, pipe.to_lda_state(ss).W.numpy())
    assert pipe.nbytes(ss) == (tr.n_docs * 16 + 16) * 4


# ---------------------------------------------------------------------------
# mid-epoch checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", PATHS[:3], ids=PATH_IDS[:3])
@pytest.mark.parametrize("disk", [False, True], ids=["streamed", "disk"])
def test_mid_epoch_checkpoint_resumes_bitwise(corpus, extra, disk, tmp_path):
    """``run_shards``, ``engine.save()`` mid-epoch, a fresh engine
    resumes it, and both finish: bitwise the uninterrupted run."""
    kw = dict(fused=True, eval_every=1, **extra)
    cfg = _disk(_store(corpus, tmp_path), **kw) if disk else _streamed(**kw)
    src = None if disk else corpus
    ref = LDAEngine(src, cfg, device="cpu")
    ref.fit(3)

    eng = LDAEngine(src, cfg, device="cpu",
                    checkpoint_dir=str(tmp_path / "ck"))
    eng.fit(1)
    pipe = eng.trainer.fused_pipeline()
    eng._state = pipe.run_shards(pipe.from_lda_state(eng.state), 2)
    assert eng.state.cursor == 2
    eng.save()
    mid = eng.host_payload()
    assert int(mid["stream_cursor"]) == 2
    assert int(mid["stream_n_shards"]) == 4
    fresh = LDAEngine(src, cfg, device="cpu",
                      checkpoint_dir=str(tmp_path / "ck")).resume()
    assert fresh.state.cursor == 2 and fresh.iteration == 1
    h_a, h_b = eng.fit(2), fresh.fit(2)       # finish epoch 2, then 3
    assert h_a["llpt"] == h_b["llpt"]
    for e in (eng, fresh):
        assert np.array_equal(e.host_payload()["topics_global"],
                              ref.host_payload()["topics_global"])
    assert eng.score() == fresh.score() == ref.score()


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("fmt", ["dense", "hybrid"])
def test_mid_epoch_payload_restores_like_the_reference(small_corpus, corpus,
                                                       writer, fmt):
    """A mid-epoch payload of either package restores in both packages'
    streamed pipelines to the same counts and deltas, bit for bit."""
    jcfg = JaxConfig(corpus_residency="streamed", stream_shards=4,
                     format=fmt, **KW)
    jt = JaxTrainer(small_corpus, jcfg, _from_engine=True)
    jp = jt.fused_pipeline()
    tt = LDATrainer(corpus, _streamed(format=fmt), device="cpu")
    tp = tt.fused_pipeline()
    if writer == "reference":
        js = jp.run_fused(jp.from_lda_state(jt.init_state()), 1)[0]
        payload = jp.stream_payload(jp.run_shards(js, 3))
    else:
        ts = tp.run_fused(tt.init_state(), 1)[0]
        payload = tp.stream_payload(tp.run_shards(ts, 3))
    assert int(payload["stream_cursor"]) == 3
    js = jp.state_from_stream_payload(payload)
    ts = LDAEngine(corpus, _streamed(format=fmt), device="cpu").restore(
        payload).state
    assert ts.cursor == js.cursor == 3
    if fmt == "dense":
        got, want = ts.counts, js.counts
    else:                                 # epoch-start densified counts
        got, want = ts.epoch.derived[:2], js.epoch.derived[:2]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ts.epoch.deltas, js.epoch.deltas):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for a, b in zip(ts.shard_topics, js.shard_topics):
        assert np.array_equal(a, np.asarray(b))
    # the port continues it bitwise: twice from the same payload
    again = tp.state_from_stream_payload(payload)
    a = tp.to_lda_state(tp.run_fused(ts, 1)[0])
    b = tp.to_lda_state(tp.run_fused(again, 1)[0])
    assert _same(a, b, a.topics.shape[0])


def test_mid_epoch_payload_guards(corpus, tmp_path):
    tr = LDATrainer(corpus, _streamed(), device="cpu")
    pipe = tr.fused_pipeline()
    ss = pipe.run_shards(tr.init_state(), 1)
    with pytest.raises(ValueError, match="epoch boundary"):
        pipe.to_lda_state(ss)
    with pytest.raises(ValueError, match="epoch boundary"):
        pipe.eval_llpt(ss)
    payload = pipe.stream_payload(ss)
    other = LDATrainer(corpus, LDAConfig(
        corpus_residency="streamed", stream_shards=3, **KW), device="cpu")
    with pytest.raises(ValueError, match="shard grid"):
        other.state_from_payload(payload)
    with pytest.raises(ValueError, match="inconsistent"):
        pipe.state_from_stream_payload(
            {**payload, "stream_done_topics": np.zeros(3, np.int32)})
    with pytest.raises(ValueError, match="different corpus"):
        pipe.state_from_stream_payload(
            {"topics_global": np.zeros(3, np.int32), "iteration": 0})
    # a resident trainer rejects it, naming the way out
    res = LDATrainer(corpus, LDAConfig(**KW), device="cpu")
    with pytest.raises(ValueError, match="corpus_residency='streamed'"):
        res.state_from_payload(payload)


def test_boundary_payloads_interchange_with_resident(corpus, tmp_path):
    res = LDAEngine(corpus, LDAConfig(fused=True, eval_every=5, **KW),
                    device="cpu")
    res.fit(2)
    dk = LDAEngine(None, _disk(_store(res.corpus, tmp_path), fused=True,
                               eval_every=5), device="cpu")
    dk.restore(res.host_payload())
    dk.fit(2)
    res.fit(2)
    assert np.array_equal(res.host_payload()["topics_global"],
                          dk.host_payload()["topics_global"])
    back = LDAEngine(corpus, LDAConfig(fused=True, **KW),
                     device="cpu").restore(dk.host_payload())
    assert back.iteration == dk.iteration and back.score() == dk.score()


# ---------------------------------------------------------------------------
# against the reference's epoch, planners and engine guards
# ---------------------------------------------------------------------------

def test_one_streamed_epoch_matches_the_reference(small_corpus, corpus):
    """Both packages' streamed epochs on the same topics and the
    reference's own uniforms."""
    jt = JaxTrainer(small_corpus, JaxConfig(
        corpus_residency="streamed", stream_shards=4, **KW),
        _from_engine=True)
    jp = jt.fused_pipeline()
    js = jp.from_lda_state(jt.init_state())
    n = jp.n_tokens
    u = np.array(jax.random.uniform(jax.random.split(js.key)[1], (n,)))
    tt = LDATrainer(corpus, _streamed(), device="cpu")
    tp = tt.fused_pipeline()
    topics0 = np.concatenate([np.asarray(t) for t in js.shard_topics])[:n]
    ts = tp.state_from_stream_payload(
        {"topics_global": topics0[:tt.n_real_tokens], "iteration": 0})
    D0, W0, _ = ts.counts
    assert np.array_equal(D0.numpy(), np.asarray(js.counts[0]))
    W_hat = esca.compute_w_hat(W0, 0.01).numpy()
    D0 = D0.numpy().copy()
    ts = tp._open_epoch(ts, u=torch.from_numpy(u))
    ts = tp.run_fused(ts, 1)[0]
    js = jp.run_fused(js, 1)[0]
    got = np.concatenate(ts.shard_topics)[:n]
    want = np.concatenate([np.asarray(t) for t in js.shard_topics])[:n]
    padded = shard_stream(corpus, 4, multiple=512)
    v = padded.word_ids.reshape(-1)[:n]
    d = padded.doc_ids.reshape(-1)[:n]
    assert assert_topics_agree(u, D0[d], W_hat[v], tt.config.alpha_, got,
                               want) <= 2
    # the port's counts are its own topics' counts, exactly
    D1, W1, cs1 = ts.counts
    D_ref, W_ref = esca.update_counts(
        torch.from_numpy(v), torch.from_numpy(d), torch.from_numpy(got),
        torch.from_numpy(padded.mask.reshape(-1)[:n]), n_docs=tt.n_docs,
        n_words=tt.n_words, n_topics=16)
    assert torch.equal(D1, D_ref) and torch.equal(W1, W_ref)
    assert torch.equal(cs1, W_ref.sum(dim=0, dtype=torch.int32))


@pytest.mark.parametrize("n,budget,multiple", [
    (10 ** 6, 64 << 20, 1), (10 ** 6, 4 << 20, 1), (4096, 1, 1024),
    (0, None, 1), (10 ** 8, 40 << 30, 8192), (3 * 10 ** 9, 40 << 30, 8192),
    (12345, None, 512)])
def test_plan_stream_shards_matches_the_reference(n, budget, multiple):
    assert lda_step.plan_stream_shards(n, budget, multiple=multiple) == \
        jax_step.plan_stream_shards(n, budget, multiple=multiple)


@pytest.mark.parametrize("knobs,n", [
    (dict(), 10 ** 9), (dict(corpus_residency="streamed", stream_shards=6),
                        1000),
    (dict(corpus_residency="streamed", device_budget_bytes=1 << 20), 10 ** 6),
    (dict(corpus_residency="auto", device_budget_bytes=1 << 20), 10 ** 6),
    (dict(corpus_residency="auto", device_budget_bytes=1 << 30), 10 ** 6),
    (dict(corpus_residency="auto", corpus_path="/somewhere"), 10 ** 6),
    (dict(corpus_residency="disk", corpus_path="/somewhere"), 10 ** 6),
    (dict(corpus_residency="auto"), 10 ** 6)])
def test_resolve_residency_matches_the_reference(knobs, n):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = lda_step.resolve_residency(LDAConfig(n_topics=8, **knobs), n,
                                         torch.device("cpu"))
    assert got == jax_step.resolve_residency(JaxConfig(n_topics=8, **knobs),
                                             n)
    assert lda_step.resolves_to_disk(LDAConfig(n_topics=8, **knobs)) == \
        jax_step.resolves_to_disk(JaxConfig(n_topics=8, **knobs))


@pytest.mark.parametrize("n", [10 ** 7, 6 * 10 ** 7])
def test_auto_residency_prices_the_resident_path_not_its_token_list(n):
    """Where the budget holds the token list (16 B a token) but not the
    port's resident path, "auto" streams here and stays resident in the
    reference: the one deliberate difference of the policy."""
    knobs = dict(n_topics=8, corpus_residency="auto",
                 device_budget_bytes=1 << 30)
    assert lda_step.STREAM_BYTES_PER_TOKEN * n < 1 << 30 \
        < lda_step.RESIDENT_BYTES_PER_TOKEN * n
    assert lda_step.resolve_residency(LDAConfig(**knobs), n)[0] == "streamed"
    assert jax_step.resolve_residency(JaxConfig(**knobs), n) == ("full", 1)


def test_auto_residency_streams_past_the_budget(corpus):
    tokens = lda_step.RESIDENT_BYTES_PER_TOKEN * (
        -(-corpus.n_tokens // 512) * 512)
    small = LDATrainer(corpus, LDAConfig(
        corpus_residency="auto", device_budget_bytes=tokens // 2, **KW),
        device="cpu")
    big = LDATrainer(corpus, LDAConfig(
        corpus_residency="auto", device_budget_bytes=tokens * 10, **KW),
        device="cpu")
    assert (small.residency, big.residency) == ("streamed", "full")


def test_disk_engine_guards(corpus, tmp_path):
    cfg = _disk(_store(corpus, tmp_path))
    with pytest.raises(ValueError, match="corpus=None"):
        LDAEngine(corpus, cfg, device="cpu")
    with pytest.raises(ValueError, match="disk"):
        LDAEngine(None, LDAConfig(**KW), device="cpu")
    eng = LDAEngine(None, cfg, device="cpu")
    eng.fit(1)
    with pytest.raises(ValueError, match="resident"):
        eng.trainer.step(eng.state)
    with pytest.raises(ValueError, match="tile_size"):
        LDAEngine(None, LDAConfig(corpus_residency="disk",
                                  corpus_path=cfg.corpus_path,
                                  n_topics=16, tile_size=384), device="cpu")
    with pytest.raises(ValueError, match="warp"):
        lda_step.StreamingPipeline(
            shard_stream(corpus, 2, multiple=512), n_docs=corpus.n_docs,
            n_words=corpus.n_words,
            config=LDAConfig(sampler="warp", corpus_residency="auto", **KW))


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_retries_then_surfaces_from_take():
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise OSError("transient")
        return x * 2

    pf = _Prefetcher(retries=2, backoff_s=0.001)
    pf.submit(flaky, 21)
    assert pf.take() == 42 and len(calls) == 3
    assert pf.take() is None

    def broken():
        raise OSError("disk gone")

    pf.submit(broken)
    with pytest.raises(OSError, match="disk gone"):
        pf.take()
    with pytest.raises(RuntimeError, match="one deep"):
        pf.submit(broken)
        pf.submit(broken)
    pf.close()                              # the pending failure stays put


def test_prefetcher_watchdog_and_quiet_close():
    pf = _Prefetcher(deadline_s=0.05)
    pf.submit(time.sleep, 1.0)
    t0 = time.perf_counter()
    with pytest.raises(PrefetchTimeout, match="watchdog"):
        pf.take()
    assert time.perf_counter() - t0 < 0.9
    pf.close()


def test_streaming_pipeline_watchdog_surfaces_from_the_epoch(corpus,
                                                             monkeypatch):
    tr = LDATrainer(corpus, LDAConfig(
        corpus_residency="streamed", stream_shards=4,
        stream_watchdog_seconds=0.05, **KW), device="cpu")
    pipe = tr.fused_pipeline()
    ss = tr.init_state()
    slow = pipe._load_shard_slices

    def stalled(s):
        if s == 2:
            time.sleep(0.5)
        return slow(s)

    monkeypatch.setattr(pipe, "_load_shard_slices", stalled)
    with pytest.raises(PrefetchTimeout):
        pipe.run_fused(ss, 1)
