"""The port's serving artifact (``FrozenLDAModel``, fold-in) against the
reference's (``src/repro/lda/api.py``).

* The same payload restored into both engines exports the same W, Ŵ and
  per-word stats, bitwise; ``from_payload`` and ``save``/``load`` give the
  same W in both packages, and a file either package saves loads in the
  other; ``prepare_batch``'s grid and ``top_words`` are bitwise.
* Fold-in: the sweep's random streams are prefix-stable; one port sweep
  fed the JAX sweep's uniforms and previous topics draws the JAX sweep's
  topics; the port's fold-in matches the float64 NumPy oracle of
  ``tests/test_serving.py``; ``score`` on the training documents lands
  near ``engine.score()``.

Tolerances: integer grids, counts and topic ids bitwise; Ŵ and the word
stats bitwise (Ŵ is computed with the reference's float32 operations in
NumPy; Q' and ΣŴ are float32 sums over K = 8 topics, exact in either
order here). A drawn topic may differ from the JAX sweep's or the
oracle's only where the float64 draw lies within 1e-4 of the total mass
of a CDF boundary (the reference's own oracle margin), on at most 1% of
the real tokens. ``score`` within 0.15 bits of ``engine.score()``, as in
the reference's test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lda.api import FrozenLDAModel as JaxModel
from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.corpus import synthetic_lda_corpus
from repro.lda.model import LDAConfig as JaxConfig
from repro_torch.core import esca
from repro_torch.kernels import histogram as hist
from repro_torch.lda import api
from repro_torch.lda.api import FrozenLDAModel, LDAEngine
from repro_torch.lda.model import LDAConfig, uniforms_generator
from repro_torch.train.lda_step import draw_uniforms
from _torch_parity import port_corpus

KW = dict(n_topics=8, tile_size=256, eval_every=5, fused=True)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def raw_corpus():
    # raw (unrelabeled): the engines prep it, so word_map is exercised
    return synthetic_lda_corpus(0, n_docs=40, n_words=40, n_topics=4,
                                mean_doc_len=14)


@pytest.fixture(scope="module")
def jax_engine(raw_corpus):
    eng = JaxEngine(raw_corpus, JaxConfig(**KW), backend="single")
    eng.fit(15)
    return eng


@pytest.fixture(scope="module")
def same_state(raw_corpus, jax_engine):
    """A port engine holding the JAX engine's state."""
    return LDAEngine(port_corpus(raw_corpus), LDAConfig(**KW),
                     device="cpu").restore(jax_engine.host_payload())


@pytest.fixture(scope="module")
def engine(raw_corpus):
    """A port engine trained by the port."""
    eng = LDAEngine(port_corpus(raw_corpus), LDAConfig(**KW), device="cpu")
    eng.fit(15)
    return eng


@pytest.fixture(scope="module")
def held_docs():
    rng = np.random.default_rng(7)
    return [list(rng.integers(0, 40, 12)) for _ in range(6)]


def _boundary_margin(u, w_row, d_row, alpha):
    """float64 distance of the draw from its nearest CDF boundary, as a
    fraction of the total mass, and the float64 oracle's topic."""
    K = w_row.shape[0]
    k1 = int(np.argmax(w_row))
    mass = np.where(np.arange(K) == k1, 0.0, (d_row + alpha) * w_row)
    m = w_row[k1] * (d_row[k1] + alpha)
    cum = np.cumsum(mass)
    x = u * (m + cum[-1])
    topic = k1 if x < m else int(min(np.searchsorted(cum, x - m,
                                                     side="right"), K - 1))
    bounds = np.concatenate([[m], m + cum])
    return np.min(np.abs(x - bounds)) / (m + cum[-1]), topic


def _agree(u, prev, got, want, model, wid, did, msk, B):
    """Topics ``got`` equal ``want`` on the real tokens except within
    MARGIN of a boundary of the float64 draw from ``prev``'s counts;
    returns (mismatches, real tokens)."""
    K, V = model.n_topics, model.n_words
    W = model.W.astype(np.float64)
    w_hat = (W + model.beta) / (W.sum(0) + V * model.beta)
    D = np.zeros((B, K), np.int64)
    np.add.at(D, (did, prev), msk)
    bad = 0
    for i in np.flatnonzero(msk):
        if got[i] != want[i]:
            margin, _ = _boundary_margin(float(u[i]), w_hat[wid[i]],
                                         D[did[i]].astype(np.float64),
                                         float(model.alpha))
            assert margin < MARGIN, (int(i), int(got[i]), int(want[i]),
                                     margin)
            bad += 1
    real = int(msk.sum())
    assert bad <= max(1, real // 100), (bad, real)
    return bad, real


# ---------------------------------------------------------------------------
# the artifact against the reference's
# ---------------------------------------------------------------------------

def test_export_matches_reference_bitwise(jax_engine, same_state):
    """The same state exports the same W, Ŵ and word stats."""
    jm, tm = jax_engine.export(), same_state.export()
    assert tm.device.type == "cpu"
    assert np.array_equal(jm.W, tm.W) and tm.W.dtype == np.int32
    assert np.array_equal(np.asarray(jm._w_hat), tm._w_hat.numpy())
    for f in ("a", "k", "k12_packed", "q_prime", "wsum"):
        assert np.array_equal(np.asarray(getattr(jm._stats, f)),
                              getattr(tm._stats, f).numpy()), f
    assert np.array_equal(jm.word_map, tm.word_map)
    assert (jm.alpha, jm.beta, jm.g, jm.tile_size) \
        == (tm.alpha, tm.beta, tm.g, tm.tile_size)
    assert np.array_equal(jax_engine.top_words(5), same_state.top_words(5))
    assert np.array_equal(jm.top_words(5), tm.top_words(5))


def test_from_payload_and_from_state(jax_engine, same_state):
    """Counts are derived state: W rebuilt from the canonical payload
    equals the live export in both packages."""
    payload = jax_engine.host_payload()
    tm = FrozenLDAModel.from_payload(payload, same_state.corpus,
                                     same_state.config,
                                     word_map=same_state.word_map,
                                     device="cpu")
    jm = JaxModel.from_payload(payload, jax_engine.corpus,
                               jax_engine.config,
                               word_map=jax_engine.word_map)
    assert np.array_equal(tm.W, jm.W)
    assert np.array_equal(tm.W, same_state.export().W)
    fs = FrozenLDAModel.from_state(same_state.state, same_state.config,
                                   word_map=same_state.word_map,
                                   device="cpu")
    assert np.array_equal(fs.W, same_state.state.W.numpy())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_save_load_cross_packages(jax_engine, same_state, held_docs,
                                  tmp_path, writer):
    """A model saved by either package loads in the other with the same
    arrays and hyperparameters, and serves the same in its own package."""
    path = str(tmp_path / "frozen.npz")
    if writer == "reference":
        jax_engine.export().save(path)
        back = FrozenLDAModel.load(path, device="cpu")
        ref = same_state.export()
    else:
        same_state.export().save(path)
        back = JaxModel.load(path)
        ref = jax_engine.export()
    assert np.array_equal(back.W, ref.W) and back.W.dtype == np.int32
    assert np.array_equal(back.word_map, ref.word_map)
    assert (back.alpha, back.beta, back.g, back.tile_size) \
        == (ref.alpha, ref.beta, ref.g, ref.tile_size)
    if writer == "reference":
        t1 = back.transform(held_docs, n_sweeps=5, seed=2)
        t2 = ref.transform(held_docs, n_sweeps=5, seed=2)
        assert np.array_equal(t1, t2)


def test_prepare_batch_grid_bitwise(jax_engine, same_state, held_docs):
    """The (B, L) grid, word_map applied: B the next power of two with
    floor 8, L with floor 16, pad slots word 0 with mask 0."""
    jm, tm = jax_engine.export(), same_state.export()
    docs = held_docs + [[3], list(range(40)) * 2]
    jb, tb = jm.prepare_batch(docs), tm.prepare_batch(docs)
    for f in ("word_ids", "doc_ids", "mask"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (jb.n_docs, jb.n_real_docs) == (tb.n_docs, tb.n_real_docs) \
        == (8, 8)
    assert tb.word_ids.shape[0] == 8 * 128
    assert np.array_equal(jb.doc_lens, tb.doc_lens)
    with pytest.raises(ValueError, match="at least one"):
        tm.prepare_batch([])
    with pytest.raises(ValueError, match="vocabulary"):
        tm.prepare_batch([[0, 1, tm.n_words + 3]])


def test_one_sweep_matches_the_jax_sweep(jax_engine, same_state, held_docs):
    """Teacher-forced: the port's sweep, fed the JAX sweep's uniforms
    (``fold_in(ksweep, s)``) and its topics after s sweeps, draws the JAX
    topics after s + 1 sweeps on every real token but those within
    MARGIN of a CDF boundary."""
    jm, tm = jax_engine.export(), same_state.export()
    key = jax.random.PRNGKey(5)
    _, ksweep = jax.random.split(key)
    b0 = jm.prepare_batch(held_docs)
    wid, did, msk = (np.asarray(x) for x in b0[:3])
    n, B = wid.shape[0], b0.n_docs
    tb = tm.prepare_batch(held_docs)
    plan = tm.count_plan(tb)

    def jax_topics(s):
        return np.array(jm.transform_batch(jm.prepare_batch(held_docs),
                                           key, n_sweeps=s)[2])

    prev, bad, real = jax_topics(0), 0, 0
    for s in range(3):
        u = np.array(jax.random.uniform(jax.random.fold_in(ksweep, s),
                                        (n,), dtype=jnp.float32))
        want = jax_topics(s + 1)
        got, D, _ = tm.sweep(tb, torch.from_numpy(u),
                             torch.from_numpy(prev), plan=plan)
        # the batch D the sweep rebuilt is the reference's of its topics
        Dw = np.zeros((B, tm.n_topics), np.int32)
        np.add.at(Dw, (did, got.numpy()), msk)
        assert np.array_equal(D.numpy(), Dw)
        b, r = _agree(u.astype(np.float64), prev, got.numpy(), want, tm,
                      wid, did, msk, B)
        bad, real = bad + b, real + r
        prev = want
    assert real >= 100


def test_fold_in_matches_numpy_oracle(engine, held_docs):
    """The port's fold-in, teacher-forced sweep by sweep against the
    float64 exact three-branch draw on its own uniforms."""
    model = engine.export()
    seed = 5
    b = model.prepare_batch(held_docs)
    wid, did, msk = (x.numpy() for x in b[:3])
    n, B = wid.shape[0], b.n_docs
    prev = model.transform_batch(b, seed, n_sweeps=0)[2].numpy()
    real = 0
    for s in range(3):
        u = draw_uniforms(seed, s, n, torch.device("cpu")).numpy()
        nxt = model.transform_batch(b, seed, n_sweeps=s + 1)[2].numpy()
        W = model.W.astype(np.float64)
        w_hat = (W + model.beta) / (W.sum(0) + model.n_words * model.beta)
        D = np.zeros((B, model.n_topics), np.int64)
        np.add.at(D, (did, prev), msk)
        oracle = nxt.copy()
        for i in np.flatnonzero(msk):
            oracle[i] = _boundary_margin(float(u[i]), w_hat[wid[i]],
                                         D[did[i]].astype(np.float64),
                                         float(model.alpha))[1]
        real += _agree(u.astype(np.float64), prev, nxt, oracle, model,
                       wid, did, msk, B)[1]
        prev = nxt
    assert real >= 100, "oracle corpus too small to mean anything"


def test_sweeps_are_prefix_stable(engine, held_docs):
    """Stream (seed, 0) draws the initial topics and (seed, s + 1) sweep
    s's uniforms: n_sweeps = s is bitwise the first s sweeps of a longer
    run, and the same seed gives the same θ."""
    model = engine.export()
    seed, cpu = 3, torch.device("cpu")
    b = model.prepare_batch(held_docs)
    n = b.word_ids.shape[0]
    t0 = model.transform_batch(b, seed, n_sweeps=0)[2]
    assert torch.equal(t0, esca.init_topics(uniforms_generator(seed, 0, cpu),
                                            (n,), model.n_topics))
    plan = model.count_plan(b)
    topics, D = t0, None
    for s in range(5):
        topics, D, _ = model.sweep(b, draw_uniforms(seed, s, n, cpu),
                                   topics, D, plan)
        if s in (2, 4):
            theta, D_s, t_s, _, skips = model.transform_batch(
                b, seed, n_sweeps=s + 1)
            assert torch.equal(t_s, topics) and torch.equal(D_s, D)
            assert skips.shape == (s + 1,)
    t1 = model.transform(held_docs, n_sweeps=6, seed=3)
    assert np.array_equal(t1, model.transform(held_docs, n_sweeps=6, seed=3))
    assert t1.shape == (len(held_docs), model.n_topics)
    assert np.allclose(t1.sum(axis=1), 1.0, atol=1e-5)
    assert not np.array_equal(t1, model.transform(held_docs, n_sweeps=6,
                                                  seed=4))


def test_fold_in_runs_through_the_kernel_wrappers(engine, held_docs,
                                                  monkeypatch):
    """Every sweep draws its survivors through ``sample_fused_rows`` and
    rebuilds the batch D through the ``histogram`` kernel's sorted route
    (on the CPU both take their twins); the initial D is one more
    rebuild."""
    model = engine.export()
    calls = {"sample_fused_rows": 0, "histogram_sorted": 0}

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(api, "sample_fused_rows", counting(
        "sample_fused_rows", api.sample_fused_rows))
    monkeypatch.setattr(hist, "histogram_sorted", counting(
        "histogram_sorted", hist.histogram_sorted))
    res = model.fold_in(held_docs, n_sweeps=4, seed=1)
    assert calls == {"sample_fused_rows": 4, "histogram_sorted": 5}
    assert res.frac_skipped.shape == (4,)
    assert np.all((res.frac_skipped >= 0) & (res.frac_skipped <= 1))
    assert np.isfinite(res.llpt)
    # the held-out LLPT is Eq 5 of the returned θ with the frozen Ŵ, over
    # the real tokens (float32 against float64: within 1e-5 bits)
    batch = model.prepare_batch(held_docs)
    theta, _, _, ll, _ = model.transform_batch(batch, 1, n_sweeps=4)
    real = batch.mask.numpy() > 0
    w = model.W.astype(np.float64) + model.beta
    w_hat = w / w.sum(axis=0)
    p = (theta.numpy().astype(np.float64)[batch.doc_ids.numpy()[real]]
         * w_hat[batch.word_ids.numpy()[real]]).sum(axis=1)
    assert float(ll) == pytest.approx(np.log2(p).mean(), abs=1e-5)
    assert float(ll) == res.llpt


def test_score_on_training_docs_matches_evaluate(engine, raw_corpus):
    """Fold-in re-derives what training already knows: the LLPT of the
    training documents lands within 0.15 bits of ``engine.score()``."""
    ev = engine.score()
    sc = engine.export().score(raw_corpus.documents(), n_sweeps=30, seed=0)
    assert abs(ev - sc) < 0.15, (ev, sc)


def test_serving_needs_a_card_unless_asked_for_the_cpu(engine, tmp_path,
                                                       monkeypatch):
    """``device=None`` means the card: without one, the constructors and
    ``load`` raise instead of serving on the CPU."""
    path = engine.export().save(str(tmp_path / "m.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FrozenLDAModel.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FrozenLDAModel(W=engine.export().W, alpha=0.1, beta=0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FrozenLDAModel.from_state(engine.state, engine.config)
    assert FrozenLDAModel.load(path, device="cpu").device.type == "cpu"
