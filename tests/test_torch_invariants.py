"""The port's count tripwires (``lda/invariants.py``) against the reference's.

Each ``check_*`` gets the same seeded NumPy inputs in both packages, clean
and with each corruption, and must raise in both or in neither, with the
same ``invariant``, ``where`` and ``detail``; the port gives the same
verdict on torch tensors. Then the pipelines' tripwires: the same topics
give both packages the same counts, one corrupted cell of the live state
trips ``selfcheck`` with the same message, and a corrupted delta trips the
streamed and disk epoch close. A non-finite LLPT trips ``evaluate``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lda import invariants as jax_inv
from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.model import LDAConfig as JaxConfig
from repro.lda.corpus import shard_stream as jax_shard_stream
from repro_torch.core import mh
from repro_torch.lda import LDAConfig, LDAEngine, invariants
from repro_torch.lda.convert import key_data
from repro_torch.lda.corpus import shard_stream
from _torch_parity import port_corpus

pytestmark = pytest.mark.chaos

M, V, K, N = 6, 7, 5, 40


def _outcome(check, *args, **kw):
    """None, or the (invariant, where, detail) of the violation raised."""
    try:
        check(*args, **kw)
    except RuntimeError as e:
        return e.invariant, e.where, e.detail
    return None


def _both(name, *args, **kw):
    """Outcome in the reference, in the port on the NumPy inputs, and in
    the port on the same inputs as torch tensors."""
    as_t = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
            else a for a in args]
    return (_outcome(getattr(jax_inv, name), *args, **kw),
            _outcome(getattr(invariants, name), *args, **kw),
            _outcome(getattr(invariants, name), *as_t, **kw))


def _counts(seed=0):
    rng = np.random.default_rng(seed)
    doc, word = rng.integers(0, M, N), rng.integers(0, V, N)
    topic = rng.integers(0, K, N)
    D = np.zeros((M, K), np.int32)
    W = np.zeros((V, K), np.int32)
    np.add.at(D, (doc, topic), 1)
    np.add.at(W, (word, topic), 1)
    return D, W, W.sum(axis=0).astype(np.int32)


def _first(a, pred):
    return tuple(int(i) for i in np.argwhere(pred(a))[0])


def _dense_case(kind):
    D, W, cs = _counts()
    n = N
    if kind == "d_short":
        D[_first(D, lambda a: a > 0)] -= 1
    elif kind == "d_negative":
        D[_first(D, lambda a: a == 0)] = -1
    elif kind == "w_negative":
        W[_first(W, lambda a: a == 0)] = -2
    elif kind == "w_moved_between_topics":
        v, k = _first(W, lambda a: a > 0)
        W[v, k] -= 1
        W[v, (k + 1) % K] += 1
    elif kind == "colsum_off":
        cs[3] += 1
    elif kind == "n_tokens_off":
        n = N + 1
    elif kind == "empty":
        D, W, cs, n = D[:0], W[:0], np.zeros(K, np.int32), 0
    return D, W, cs, n


DENSE_CASES = ["clean", "d_short", "d_negative", "w_negative",
               "w_moved_between_topics", "colsum_off", "n_tokens_off",
               "empty"]


@pytest.mark.parametrize("kind", DENSE_CASES)
@pytest.mark.parametrize("with_colsum", [True, False])
def test_check_dense_counts_matches_the_reference(kind, with_colsum):
    D, W, cs, n = _dense_case(kind)
    args = (D, W, cs) if with_colsum else (D, W)
    want, got, got_t = _both("check_dense_counts", *args, n_tokens=n,
                             where="unit")
    assert got == want and got_t == want
    silent = kind in ("clean", "empty") or (not with_colsum and kind in (
        "colsum_off", "w_moved_between_topics"))
    assert (want is None) == silent


def _deltas(seed=1):
    rng = np.random.default_rng(seed)
    dD = np.zeros((M, K), np.int32)
    dW = np.zeros((V, K), np.int32)
    for _ in range(25):
        d, v = rng.integers(0, M), rng.integers(0, V)
        old, new = rng.integers(0, K, 2)
        dD[d, old] -= 1
        dD[d, new] += 1
        dW[v, old] -= 1
        dW[v, new] += 1
    return dD, dW, dW.sum(axis=0).astype(np.int32)


@pytest.mark.parametrize("kind", ["clean", "dD_off", "dW_off",
                                  "dcolsum_off", "no_dW", "no_dcolsum"])
def test_check_delta_conservation_matches_the_reference(kind):
    dD, dW, dcs = _deltas()
    if kind == "dD_off":
        dD[0, 0] += 1
    elif kind == "dW_off":
        dW[2, 1] -= 3
    elif kind == "dcolsum_off":
        dcs[2] += 2
    elif kind == "no_dW":
        dW = None
        dD[1, 1] += 1
    args = (dD, dW) if kind == "no_dcolsum" else (dD, dW, dcs)
    want, got, got_t = _both("check_delta_conservation", *args,
                             where="unit")
    assert got == want and got_t == want
    assert (want is None) == (kind in ("clean", "no_dcolsum"))


@pytest.mark.parametrize("kind", ["clean", "overflow", "negative",
                                  "short"])
def test_check_packed_counts_matches_the_reference(kind):
    _, _, cs = _counts()
    ov = np.int32(3 if kind == "overflow" else 0)
    if kind == "negative":
        cs[1] = -1
    elif kind == "short":
        cs[0] -= 1
    want = _outcome(jax_inv.check_packed_counts, cs, ov, n_tokens=N,
                    where="unit")
    for c, o in ((cs, ov), (torch.from_numpy(cs), torch.tensor(int(ov))),
                 (cs, int(ov))):
        assert _outcome(invariants.check_packed_counts, c, o, n_tokens=N,
                        where="unit") == want
    assert (want is None) == (kind == "clean")


def _tables(seed=2, R=9, k=13):
    w = torch.from_numpy(np.random.default_rng(seed).gamma(
        0.3, size=(R, k)).astype(np.float32) + 1e-3)
    t = mh.build_alias_tables(w)
    return t.prob.numpy().copy(), t.alias.numpy().copy(), t.q.numpy().copy()


ALIAS_CASES = ["clean", "prob_above_one", "prob_negative", "prob_nan",
               "prob_inf", "alias_K", "alias_negative", "q_shifted",
               "prob_shifted"]


@pytest.mark.parametrize("kind", ALIAS_CASES)
@pytest.mark.parametrize("with_q", [True, False])
def test_check_alias_tables_matches_the_reference(kind, with_q):
    prob, alias, q = _tables()
    k = prob.shape[1]
    if kind == "prob_above_one":
        prob[0, 0] = 1.5
    elif kind == "prob_negative":
        prob[3, 2] = -0.25
    elif kind == "prob_nan":
        prob[2, 3] = np.nan
    elif kind == "prob_inf":
        prob[1, 1] = np.inf
    elif kind == "alias_K":
        alias[4, 5] = k
    elif kind == "alias_negative":
        alias[5, 0] = -1
    elif kind == "q_shifted":
        q[6] = np.roll(q[6], 1)
    elif kind == "prob_shifted":
        prob[7, _first(prob[7:8], lambda a: a < 0.5)[1]] += 0.4
    args = (prob, alias, q) if with_q else (prob, alias)
    want, got, got_t = _both("check_alias_tables", *args, where="unit")
    assert got == want and got_t == want
    silent = kind == "clean" or (not with_q and kind in ("q_shifted",
                                                         "prob_shifted"))
    assert (want is None) == silent


def test_port_alias_tables_pass_and_reconstruct_q():
    """The port's plain table build passes its own check at K = 1 too."""
    for R, k in ((1, 1), (4, 2), (9, 13), (3, 1000)):
        prob, alias, q = _tables(R=R, k=k)
        invariants.check_alias_tables(prob, alias, q, where="unit")


@pytest.mark.parametrize("kind", ["clean", "nan", "inf", "negative"])
def test_check_theta_matches_the_reference(kind):
    th = np.random.default_rng(3).dirichlet(np.ones(K), size=4)
    if kind == "nan":
        th[1, 2] = np.nan
    elif kind == "inf":
        th[0, 0] = np.inf
        th[3, 1] = np.nan
    elif kind == "negative":
        th[2, 4] = -0.125
    want, got, got_t = _both("check_theta", th, where="unit")
    assert got == want and got_t == want
    assert (want is None) == (kind == "clean")


# ---------------------------------------------------------------------------
# the pipelines' tripwires, on the same counts in both packages
# ---------------------------------------------------------------------------

KW = dict(n_topics=8, tile_size=256, eval_every=4, seed=3)


def _same_states(small_corpus, **kw):
    """(reference pipeline, its state, port pipeline, its state) built from
    the same seeded topics, so both hold the same counts."""
    ref = JaxEngine(small_corpus, JaxConfig(fused=True, **KW, **kw),
                    backend="single")
    port = LDAEngine(port_corpus(small_corpus),
                     LDAConfig(fused=True, selfcheck=True, **KW, **kw),
                     device="cpu")
    n_real, n_pad = port.trainer.n_real_tokens, port.trainer.n_padded_tokens
    assert ref.trainer.n_padded_tokens == n_pad
    topics = np.zeros(n_pad, np.int32)
    topics[:n_real] = np.random.default_rng(5).integers(0, 8, n_real)
    rs = ref.trainer.state_from_payload(
        {"topics": topics, "key": key_data(3), "iteration": 2})
    ps = port.trainer.state_from_topics(topics, 2)
    rp, pp = ref.trainer.fused_pipeline(), port.trainer.fused_pipeline()
    return rp, rp.from_lda_state(rs), pp, pp.from_lda_state(ps), n_real


def test_dense_selfcheck_trips_like_the_reference(small_corpus):
    rp, rf, pp, pf, n_real = _same_states(small_corpus)
    rp.selfcheck(rf)
    pp.selfcheck(pf)                              # clean: both pass
    want = _outcome(rp.selfcheck, rf._replace(D=rf.D.at[1, 2].add(-1)))
    pf.D[1, 2] -= 1
    got = _outcome(pp.selfcheck, pf)
    assert got == want and got[0] == "token_conservation"
    assert got[1] == "chunk boundary (iteration 2)"
    pf.D[1, 2] += 1
    want = _outcome(rp.selfcheck, rf._replace(
        colsum=rf.colsum.at[4].add(1)))
    pf.colsum[4] += 1
    assert _outcome(pp.selfcheck, pf) == want
    assert want[0] == "colsum_matches_w"


def test_hybrid_selfcheck_trips_like_the_reference(small_corpus):
    rp, rh, pp, ph, n_real = _same_states(small_corpus, format="hybrid")
    rp.selfcheck(rh)
    pp.selfcheck(ph)
    want = _outcome(rp.selfcheck, rh._replace(overflow=jnp.int32(2)))
    got = _outcome(pp.selfcheck, ph._replace(
        overflow=torch.tensor(2, dtype=torch.int32)))
    assert got == want and got[0] == "packed_overflow"
    want = _outcome(rp.selfcheck, rh._replace(colsum=rh.colsum.at[0].add(-1)))
    ph.colsum[0] -= 1
    assert _outcome(pp.selfcheck, ph) == want
    assert want[0] == "token_conservation"


@pytest.mark.parametrize("disk", [False, True], ids=["streamed", "disk"])
def test_epoch_close_trips_on_a_corrupted_delta(small_corpus, tmp_path,
                                                disk):
    """A ΔD cell bumped mid-epoch: the port's epoch close refuses to land
    it, with the reference's message; paged, a bumped host ΔW too."""
    if disk:
        jstore = jax_shard_stream(small_corpus, 4, multiple=256).to_store(
            str(tmp_path / "jax"))
        pstore = shard_stream(port_corpus(small_corpus), 4,
                              multiple=256).to_store(str(tmp_path / "port"))
        ref = JaxEngine(None, JaxConfig(corpus_residency="disk",
                                        corpus_path=jstore.path,
                                        selfcheck=True, **KW),
                        backend="single")
        port = LDAEngine(None, LDAConfig(corpus_residency="disk",
                                         corpus_path=pstore.path,
                                         selfcheck=True, **KW), device="cpu")
    else:
        kw = dict(corpus_residency="streamed", stream_shards=4,
                  selfcheck=True, **KW)
        ref = JaxEngine(small_corpus, JaxConfig(**kw), backend="single")
        port = LDAEngine(port_corpus(small_corpus), LDAConfig(**kw),
                         device="cpu")
    rp, pp = ref.trainer.fused_pipeline(), port.trainer.fused_pipeline()
    rs = rp.run_shards(rp.from_lda_state(ref.trainer.init_state()), 2)
    ps = pp.run_shards(pp.from_lda_state(port.trainer.init_state()), 2)
    dD = rs.epoch.deltas[0]
    rs.epoch.deltas = (dD.at[0, 0].add(1),) + tuple(rs.epoch.deltas[1:])
    ps.epoch.deltas[0][0, 0] += 1
    want = _outcome(rp.run_fused, rs, 1)
    got = _outcome(pp.run_fused, ps, 1)
    assert got == want
    assert got == ("delta_conservation", "epoch 0 close (deltas)",
                   "sum(dD)=1, expected 0")
    if disk:                       # ΔW lives on the host, in HostPages
        rs = rp.run_shards(rp.from_lda_state(ref.trainer.init_state()), 3)
        ps = pp.run_shards(pp.from_lda_state(port.trainer.init_state()), 3)
        rp._drain_dw(rs)
        rs.epoch.dw_host[1, 1] -= 2
        pp._resolve_pending(ps, keep=0)
        ps.pages.dw[1, 1] -= 2
        want = _outcome(rp.run_fused, rs, 1)
        assert _outcome(pp.run_fused, ps, 1) == want
        assert want[2] == "sum(dW)=-2, expected 0"


def test_non_finite_llpt_trips_evaluate(small_corpus, monkeypatch):
    from repro_torch.lda import trainer as trainer_mod
    port = LDAEngine(port_corpus(small_corpus),
                     LDAConfig(selfcheck=True, **KW), device="cpu")
    off = LDAEngine(port_corpus(small_corpus), LDAConfig(**KW),
                    device="cpu")
    port.fit(1)
    monkeypatch.setattr(trainer_mod.llpt_mod, "llpt",
                        lambda *a, **k: torch.tensor(float("nan")))
    got = _outcome(port.trainer.evaluate, port.state)
    assert got == ("finite_llpt", "evaluate (iteration 1)", "llpt=nan")
    assert np.isnan(off.trainer.evaluate(port.state))   # off: no tripwire
