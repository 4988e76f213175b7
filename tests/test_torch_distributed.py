"""The port's distributed layer against the reference, in one process.

* ``shard_corpus`` (both balances, 1, 2 and 4 shards), ``chunk_documents``,
  ``assign_token_shards`` and ``load_imbalance``: bitwise the reference's.
* ``DistConfig`` and the ``LDAConfig.dist`` shim raise what the
  reference raises, with its messages.
* The topic-split sweep: the reference's ``_word_phase`` and
  ``_token_sweep`` under ``jax.vmap(..., axis_name="model")`` against the
  port's, each rank a thread over a ``model`` axis of threads, on the
  same NumPy inputs and uniforms: Ŵ and the top-(g+1) values and topic
  ids bitwise, Q' within rtol 1e-5 (ΣŴ summed in another order), the
  topics equal except tokens whose draw lies within 1e-5 of a CDF
  boundary's mass (``tests/_torch_parity.py``).
* A one-rank gloo group in this process: the distributed engine on a
  (1, 1) mesh is bitwise the single-device engine (dense, tiles,
  hybrid), the process mesh's layout and refusals.

The worlds of 2 and 4 processes are in ``test_torch_dist_engine.py``.
"""

import dataclasses
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balance as jbal
from repro.lda import distributed as jdist
from repro.lda import model as jmodel
from repro.lda.corpus import (chunk_documents as jchunk,
                              relabel_by_frequency as jrelabel,
                              synthetic_lda_corpus, zipf_corpus)
from repro.lda.corpus import from_documents as jfrom_documents
from repro_torch.core import balance as tbal
from repro_torch.lda import distributed as tdist
from repro_torch.lda import model as tmodel
from repro_torch.lda.api import LDAEngine
from repro_torch.lda.corpus import chunk_documents
from repro_torch.launch.mesh import make_lda_mesh
from repro_torch.runtime.sharding import (ProcessMesh, batch_axes,
                                          mesh_axis_size)
from _torch_dist import PAD, make_config, summary, world1
from _torch_parity import assert_topics_agree, port_corpus


@pytest.fixture(scope="module")
def ref_corpus():
    c = synthetic_lda_corpus(0, n_docs=80, n_words=100, n_topics=8,
                             mean_doc_len=50)
    return jrelabel(c)[0]


@pytest.fixture(scope="module")
def skewed():
    c = zipf_corpus(3, n_docs=150, n_words=400, exponent=1.7,
                    mean_doc_len=80)
    return jrelabel(c)[0]


# -- host-side partitioning ---------------------------------------------------

@pytest.mark.parametrize("balance", ["none", "tiles"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_corpus_bitwise_reference(ref_corpus, skewed, balance,
                                        n_shards):
    for corpus in (ref_corpus, skewed):
        want = jdist.shard_corpus(corpus, n_shards, pad_multiple=PAD,
                                  balance=balance)
        got = tdist.shard_corpus(port_corpus(corpus), n_shards,
                                 pad_multiple=PAD, balance=balance)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
        assert (got.owns is None) == (balance == "none")


def test_chunk_documents_bitwise_reference(skewed):
    for n in (1, 3, 8):
        assert np.array_equal(chunk_documents(port_corpus(skewed), n),
                              jchunk(skewed, n))


@pytest.mark.parametrize("seed,n_shards", [(0, 1), (1, 3), (7, 5), (42, 8),
                                           (1234, 12), (9999, 2)])
def test_assign_token_shards_bitwise_reference(seed, n_shards):
    # the reference's property test's corpora (tests/test_balance.py)
    rng = np.random.default_rng(seed)
    n_words = int(rng.integers(2, 50))
    docs = [rng.integers(0, n_words, rng.integers(1, 60)).tolist()
            for _ in range(int(rng.integers(1, 30)))]
    c = jfrom_documents(docs, n_words)
    for thr in (None, 3):
        want = jbal.assign_token_shards(c, n_shards, thr)
        got = tbal.assign_token_shards(port_corpus(c), n_shards, thr)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_assign_token_shards_dissects_head_word_as_reference(skewed):
    got, loads = tbal.assign_token_shards(port_corpus(skewed), 8)
    want, want_loads = jbal.assign_token_shards(skewed, 8)
    assert np.array_equal(got, want) and np.array_equal(loads, want_loads)
    assert len(np.unique(got[skewed.word_ids == 0])) >= 2
    with pytest.raises(ValueError, match="n_shards"):
        tbal.assign_token_shards(port_corpus(skewed), 0)


@pytest.mark.parametrize("scheme", ["block_per_word", "dynamic",
                                    "dynamic+dissect", "token_tiles"])
def test_load_imbalance_bitwise_reference(skewed, scheme):
    for units in (3, 8):
        got = tbal.load_imbalance(port_corpus(skewed), scheme, units,
                                  tile_size=256, dissect_threshold=500)
        assert got == jbal.load_imbalance(skewed, scheme, units,
                                          tile_size=256,
                                          dissect_threshold=500)
    with pytest.raises(ValueError):
        tbal.load_imbalance(port_corpus(skewed), "other", 3)


# -- the config ---------------------------------------------------------------

def _raised(fn):
    try:
        fn()
    except Exception as exc:                      # noqa: BLE001 — compared
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("kw", [
    dict(w_sync="gossip"), dict(balance="words"), dict(staleness=-1),
    dict(staleness=2), dict(owner_layout="cols", w_sync="ps"),
    dict(n_owners=0, w_sync="ps"), dict(n_owners=2),
    dict(mesh_shape=(("data", 0), ("model", 1))),
    dict(mesh_shape=(("data", 2),)), dict(mesh_shape=("data",)),
    dict(mesh_shape=(("data", 2), ("model", 2))),
    dict(w_sync="ps", staleness=3, owner_layout="mass", n_owners=2)])
def test_dist_config_validation_matches_reference(kw):
    got = _raised(lambda: tmodel.DistConfig(**kw))
    assert got == _raised(lambda: jmodel.DistConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(dist="replicate"), dict(balance="tiles", dist=None),
    dict(balance="tiles", dist="DistConfig"),
    dict(balance="tiles", dist="DistConfig-none"),
    dict(dist="DistConfig-tiles"), dict(balance="words")])
def test_dist_shim_matches_reference(kw, monkeypatch):
    monkeypatch.setattr(tmodel, "_LOOSE_DIST_KNOB_WARNED", False)
    monkeypatch.setattr(jmodel, "_LOOSE_DIST_KNOB_WARNED", False)

    def build(mod):
        k = dict(kw)
        if isinstance(k.get("dist"), str) and k["dist"].startswith("Dist"):
            bal = k["dist"].partition("-")[2] or "tiles"
            k["dist"] = mod.DistConfig(balance=bal)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = _raised(lambda: mod.LDAConfig(n_topics=8, **k))
            again = _raised(lambda: mod.LDAConfig(n_topics=8, **k))
        cfg = None if out else mod.LDAConfig(n_topics=8, **k)
        deps = [str(w.message) for w in rec
                if issubclass(w.category, DeprecationWarning)]
        return out, again, deps, None if cfg is None else (
            cfg.balance, cfg.dist.balance, cfg.dist.w_sync)

    got, want = build(tmodel), build(jmodel)
    assert got == want
    if kw == dict(balance="tiles", dist=None):
        assert len(got[2]) == 1                   # warns once a process


# -- the topic-split sweep against the reference ------------------------------

class _ThreadMesh:
    """A ``model`` axis of P threads: the collectives the sweep calls,
    summed in rank order behind a barrier."""

    def __init__(self, rank, shared):
        self.rank, self.s = rank, shared
        self.shape = {"model": shared["P"]}

    def axis_index(self, axis):
        return self.rank

    def _exchange(self, x):
        s = self.s
        s["slots"][self.rank] = x.clone()
        s["barrier"].wait()
        parts = list(s["slots"])
        s["barrier"].wait()
        return parts

    def psum(self, x, axes):
        total = self._exchange(x)
        out = total[0].clone()
        for p in total[1:]:
            out += p
        x.copy_(out)
        return x

    def all_gather(self, x, axis):
        return torch.stack(self._exchange(x))


def _threads(P, fn):
    shared = {"P": P, "slots": [None] * P,
              "barrier": threading.Barrier(P, timeout=60)}
    out, errs = [None] * P, []

    def run(r):
        try:
            out[r] = fn(r, _ThreadMesh(r, shared))
        except BaseException as exc:              # noqa: BLE001 — re-raised
            errs.append(exc)
            shared["barrier"].abort()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(P)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts)
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_word_phase_and_token_sweep_match_reference(P, seed):
    rng = np.random.default_rng(seed)
    M, V, K, N, g = 40, 60, 32, 3000, 2
    kl = K // P
    alpha, beta = 50.0 / K, 0.01
    W = rng.integers(0, 6, (V, K)).astype(np.int32)
    W[::5, 3] += 7                                 # shared tops across blocks
    D = rng.integers(0, 4, (M, K)).astype(np.int32)
    v = np.sort(rng.integers(0, V, N)).astype(np.int32)
    d = rng.integers(0, M, N).astype(np.int32)
    u = rng.random(N).astype(np.float32)
    len_tot = D.sum(axis=1).astype(np.float32)
    blocks = np.stack(np.split(W, P, axis=1))      # (P, V, kl)
    d_tok = np.stack(np.split(D[d], P, axis=1))    # (P, N, kl)
    kb0 = np.arange(P, dtype=np.int32) * kl
    cfg = jmodel.LDAConfig(n_topics=K, alpha=alpha, beta=beta, g=g)

    def ref_word(Wb, k0):
        return jdist._word_phase(Wb, cfg=cfg, model_axis="model",
                                 n_words=V, g=g, kb0=k0, k_local=kl)

    jw = jax.vmap(ref_word, axis_name="model")(jnp.asarray(blocks),
                                               jnp.asarray(kb0))

    def ref_sweep(dt, wh, gv, gi, qp, k0, my):
        return jdist._token_sweep(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(d), dt,
            jnp.asarray(len_tot), wh, gv, gi, qp, alpha=alpha, g=g, kb0=k0,
            k_local=kl, my=my, model_axis="model")

    js = jax.vmap(ref_sweep, axis_name="model")(
        jnp.asarray(d_tok), *jw, jnp.asarray(kb0), jnp.arange(P))

    def port(r, mesh):
        Wb = torch.from_numpy(blocks[r])
        word = tdist._word_phase(Wb, Wb.sum(dim=0, dtype=torch.int32), mesh,
                                 beta=beta, alpha=alpha, n_words=V, g=g,
                                 kb0=int(kb0[r]), k_local=kl)
        sweep = tdist._token_sweep(
            torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(d),
            torch.from_numpy(d_tok[r]), torch.from_numpy(len_tot), *word,
            mesh, alpha=alpha, g=g, kb0=int(kb0[r]), k_local=kl)
        return word, sweep

    out = _threads(P, port)
    for r in range(P):
        (w_hat, g_vals, g_idx, q), (topics, skip, in_m, k1) = out[r]
        assert np.array_equal(w_hat.numpy(), np.asarray(jw[0][r]))
        assert np.array_equal(g_vals.numpy(), np.asarray(jw[1][r]))
        assert np.array_equal(g_idx.numpy(), np.asarray(jw[2][r]))
        np.testing.assert_allclose(q.numpy(), np.asarray(jw[3][r]),
                                   rtol=1e-5)
        assert np.array_equal(k1.numpy(), np.asarray(js[3][r]))
        assert np.array_equal(topics.numpy(), out[0][1][0].numpy())
    # against the full rows: the two-level CDF is the global CDF in topic
    # order, so a topic may differ only on a boundary of it
    W_hat = np.concatenate([np.asarray(jw[0][r]) for r in range(P)], axis=1)
    n_diff = assert_topics_agree(u, D[d], W_hat[v], alpha,
                                 out[0][1][0].numpy(), np.asarray(js[0][0]))
    assert n_diff <= 0.01 * N
    assert 0 < int(out[0][1][1].sum()) < N           # some tokens skip


# -- one rank in this process -------------------------------------------------

@pytest.fixture(scope="module")
def corpus(ref_corpus):
    return port_corpus(ref_corpus)


@pytest.mark.parametrize("kw", [
    {}, dict(balance="tiles"), dict(format="hybrid", tail_sampler="sparse"),
    dict(format="hybrid", tail_sampler="exact")])
def test_world1_engine_bitwise_single(corpus, tmp_path, kw):
    cfg = make_config(eval_every=1, **kw)
    single = LDAEngine(corpus, cfg, device="cpu", backend="single")
    want = summary(single, single.fit(4))
    with world1(tmp_path):
        eng = LDAEngine(corpus, cfg, device="cpu", backend="distributed",
                        pad_multiple=PAD)
        got = summary(eng, eng.fit(4))
        assert eng.backend_name == "distributed"
        assert dict(eng.trainer.mesh.shape) == {"data": 1, "model": 1}
        W = eng.export().W
    for name in ("topics", "D", "W"):
        assert np.array_equal(got[name], want[name]), name
    assert got["llpt"] == want["llpt"] and got["score"] == want["llpt"][-1]
    assert np.array_equal(W, want["W"])


def test_world1_run_fused_matches_stepwise(corpus, tmp_path):
    """``run_fused(state, n)`` is ``step`` n times, its stats stacked (the
    reference's ``test_run_fused_matches_stepwise``)."""
    cfg = make_config()
    with world1(tmp_path):
        tr = LDAEngine(corpus, cfg, device="cpu", backend="distributed",
                       pad_multiple=PAD).trainer
        a = tr.init_state()
        for _ in range(3):
            a, last = tr.step(a)
        b, stats = tr.run_fused(tr.init_state(), 3)
    for f in ("topics", "D", "W", "colsum"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.iteration == b.iteration == 3
    assert stats.frac_skipped.shape == (3,)
    assert float(stats.frac_skipped[-1]) == float(last.frac_skipped)


def test_world1_auto_stays_single_and_mesh_layout(corpus, tmp_path):
    with world1(tmp_path):
        # a group of one rank does not make "auto" distributed
        assert LDAEngine(corpus, make_config(), device="cpu"
                         ).backend_name == "single"
        mesh = make_lda_mesh(1, 1)
        assert dict(mesh.shape) == {"data": 1, "model": 1}
        assert batch_axes(mesh) == ("data",)
        assert mesh_axis_size(mesh, ("data", "model")) == 1
        pod = make_lda_mesh(1, 1, n_pod=1)
        assert batch_axes(pod) == ("pod", "data")
        assert pod.coords == {"pod": 0, "data": 0, "model": 0}
        x = torch.arange(6, dtype=torch.int32)
        assert torch.equal(mesh.psum(x.clone(), ("data", "model")), x)
        assert torch.equal(mesh.all_gather(x, "model"), x[None])
        with pytest.raises(ValueError, match="world size 1"):
            ProcessMesh((2, 1), ("data", "model"))
        with pytest.raises(ValueError, match="distinct name"):
            ProcessMesh((1, 1), ("data", "data"))
        with pytest.raises(ValueError, match="no process group"):
            pod.psum(x, "pod")
        with pytest.raises(TypeError, match="engine-internal"):
            tdist.DistLDATrainer(corpus, make_config(), mesh)


def test_process_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        ProcessMesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_lda_mesh(1, 1)
