"""The per-rank LLPT, the rank-agreed tripwire and the supervised
replicated fit, in gloo worlds of 2 and 4 processes on the CPU.

One world of each size runs every case once (``tests/_torch_dist.py``:
``supervise2``, ``supervise4``; the reference's distributed-test corpus,
K = 16); the tests read their results.

* The LLPT without a global D: every case trains with
  ``DistLDATrainer.gather_global`` patched to raise, so ``evaluate`` and
  ``selfcheck`` (``selfcheck=True``: at every chunk boundary) build no
  ``(M, K)`` matrix. On a model axis of 1 (resident, streamed, tiles with
  dissected documents, hybrid) every LLPT is bitwise the port's single
  engine; on the (2, 2) topic split it is bitwise the port's single-engine
  LLPT of the counts it ends at, and within rtol 1e-5 of the reference's
  ``core/llpt.py`` on the same counts (``tests/test_torch_core.py``'s
  tolerance). One count moved on a rank trips ``token_conservation`` on
  every rank with one message: the one ``check_dense_counts`` gives on the
  global D and the first data shard's W.
* The supervised fit: a chaos fault on ONE rank (a step fault, an I/O
  fault in a streamed sub-shard under ``checkpoint_shards=1``, an
  out-of-memory fault that degrades every rank to streamed residency)
  becomes the same ``RankFault`` on every rank; every rank restores the
  same checkpoint, ends bitwise the uninterrupted run (topics, D, W and
  the LLPT of every iteration it evaluated) with the same restart report,
  and no rank waits for the group's timeout. A fault that is not
  restartable stops every rank: the faulted one with its own exception,
  the others with ``RankAbort``.
* Serving: ``subscribe`` and ``publish_serving`` on the replicated backend
  publish every rank's W (gathered over ``model`` on the topic split) at
  each chunk boundary, without a global D.
* ``core/llpt.py::token_ll`` gives each token the same bits whatever
  tokens share its tile, the property the per-rank LLPT rests on.
"""

import os

import numpy as np
import pytest

from repro.core import llpt as jllpt
from repro_torch.core import llpt
from repro_torch.lda.api import LDAEngine
from repro_torch.lda.corpus import pad_corpus
from repro_torch.lda.invariants import InvariantViolation, check_dense_counts
import _torch_dist as td

import jax.numpy as jnp
import torch


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("supervise")
    return {"2": td.run_world(2, "supervise2", (str(tmp / "ck2"),), tmp),
            "4": td.run_world(4, "supervise4", (str(tmp / "ck4"),), tmp),
            "dir": tmp}


def _cases(worlds, name):
    four = {c[0] for c in td.LLPT4 + td.DRILLS4}
    world = "4" if name.split("/")[0] in four else "2"
    return [r[name] for r in worlds[world]]


def _single(name, kw, iters):
    kw = {k: v for k, v in kw.items() if k != "selfcheck"}
    eng = LDAEngine(td.make_corpus(), td.make_config(eval_every=1, **kw),
                    device="cpu", backend="single")
    return td.summary(eng, eng.fit(iters))


LLPT_1 = [c for c in td.LLPT4 + td.LLPT2 if c[1][1] == 1]
SPLIT = [c for c in td.LLPT4 if c[1][1] > 1]


@pytest.mark.parametrize("case", LLPT_1, ids=[c[0] for c in LLPT_1])
def test_llpt_without_global_d_is_bitwise_single(worlds, case):
    name, _shape, kw, iters = case
    ranks = _cases(worlds, name)
    want = _single(name, kw, iters)
    for got in ranks:
        assert got["llpt"] == want["llpt"] and len(got["llpt"]) == iters
        assert got["score_no_gather"] == got["score"] == want["llpt"][-1]
        for key in ("topics", "D", "W"):
            assert np.array_equal(got[key], want[key]), key


def _llpt_of(D, W):
    """The single engine's LLPT of the counts D, W over its padded order,
    and the reference's."""
    corpus = td.make_corpus()
    padded, mask = pad_corpus(corpus, td.BASE["tile_size"])
    cfg = td.make_config()
    arrays = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
              for a in (padded.word_ids, padded.doc_ids, mask)]
    port = float(llpt.llpt(*arrays, torch.from_numpy(D), torch.from_numpy(W),
                           alpha=cfg.alpha_, beta=cfg.beta,
                           tile_size=cfg.tile_size))
    ref = float(jllpt.llpt(padded.word_ids, padded.doc_ids, mask,
                           jnp.asarray(D), jnp.asarray(W), alpha=cfg.alpha_,
                           beta=cfg.beta, tile_size=cfg.tile_size))
    return port, ref


@pytest.mark.parametrize("case", SPLIT, ids=[c[0] for c in SPLIT])
def test_topic_split_llpt_is_the_single_llpt_of_its_counts(worlds, case):
    name = case[0]
    ranks = _cases(worlds, name)
    got = ranks[0]
    port, ref = _llpt_of(got["D"], got["W"])
    assert got["score_no_gather"] == got["llpt"][-1] == port
    assert port == pytest.approx(ref, rel=1e-5)
    assert all(r["llpt"] == got["llpt"] for r in ranks)
    D, W = _histograms(got["topics"])
    assert np.array_equal(got["D"], D) and np.array_equal(got["W"], W)


def _histograms(topics, K=16):
    c = td.make_corpus()
    D = np.zeros((c.n_docs, K), np.int32)
    W = np.zeros((c.n_words, K), np.int32)
    np.add.at(D, (c.doc_ids, topics), 1)
    np.add.at(W, (c.word_ids, topics), 1)
    return D, W


DENSE = [c for c in td.LLPT4 + td.LLPT2 if "hybrid" not in c[0]]


@pytest.mark.parametrize("case", DENSE, ids=[c[0] for c in DENSE])
def test_tripwire_agrees_on_every_rank(worlds, case):
    """Rank 0 moves one count of its first D row, every other rank one of
    its W block: the sums over the ranks' own rows (W from the first data
    shard) trip with the message of the global check, the same on every
    rank."""
    name, shape, _kw, iters = case
    ranks = _cases(worlds, name)
    got = ranks[0]
    n = got["topics"].shape[0]
    pm = shape[1]
    # the first data shard's ranks are 0 .. pm-1; all but rank 0 moved W
    w_sum = n - (pm - 1)
    want = (f"invariant 'token_conservation' violated at distributed chunk "
            f"boundary (iteration {iters}): sum(D)={n - 1}, sum(W)={w_sum}, "
            f"expected {n} — restore from the newest checkpoint")
    for r in ranks:
        assert r["clean"] and r["tripped"] == want
    # the global check on such counts says the same
    Dg = _histograms(got["topics"])[0].astype(np.int64)
    Dg[0, 0] -= 1
    Wg = _histograms(got["topics"])[1].astype(np.int64)
    Wg[0, 0] -= pm - 1
    with pytest.raises(InvariantViolation) as exc:
        check_dense_counts(torch.from_numpy(Dg), torch.from_numpy(Wg),
                           n_tokens=n, where=f"distributed chunk boundary "
                           f"(iteration {iters})")
    assert str(exc.value) == want


DRILLS = td.DRILLS2 + td.DRILLS4


@pytest.mark.parametrize("case", DRILLS, ids=[c[0] for c in DRILLS])
def test_fault_on_one_rank_restarts_every_rank_bitwise(worlds, case):
    name, shape, kw, iters, faulted, plan, pol = case
    ranks = _cases(worlds, name)
    plains = _cases(worlds, name + "/plain")
    report = ranks[0]["report"]
    for got, plain in zip(ranks, plains):
        for key in ("topics", "D", "W"):
            assert np.array_equal(got[key], plain[key]), key
        assert got["iteration"] == iters
        # the LLPT of every iteration the supervised run evaluated
        by_it = dict(zip(plain["iterations"], plain["llpt"]))
        assert got["llpt"] and all(by_it[i] == v for i, v in
                                   zip(got["iterations"], got["llpt"]))
        assert got["report"] == report          # the same on every rank
        assert got["seconds"] < td.GROUP_TIMEOUT.total_seconds() / 4
    assert report["restarts"] == 1 and report["completed_steps"] == iters
    kind = next(iter(plan))
    exc = {"raise_at_steps": "InjectedFault",
           "io_fault_shards": "OSError",
           "oom_at_steps": "SimulatedOOM"}[kind]
    assert report["faults"] == [
        f"RankFault: fault agreed by every rank: rank {faulted}: {exc} ("
        + ("out-of-memory): out of memory" if kind == "oom_at_steps"
           else "restartable)")]
    oom = kind == "oom_at_steps"
    assert report["degraded_to_streamed"] is oom
    streamed = oom or kw.get("corpus_residency") == "streamed"
    assert all(r["residency"] == ("streamed" if streamed else "full")
               for r in ranks)


def test_sub_shard_fault_restores_a_mid_epoch_checkpoint(worlds):
    """``checkpoint_shards=1`` on the streamed replicated trainer cuts a
    checkpoint after every sub-shard, keyed it·(S+1)+cursor: the fault in
    sub-shard 1 restores the one cut after sub-shard 0, inside epoch 0."""
    (name, _shape, kw, iters, *_), = [c for c in td.DRILLS2
                                      if "io_fault" in c[0]]
    S = kw["stream_shards"]
    got = _cases(worlds, name)[0]
    assert got["report"]["resumed_from"] == [0]
    steps = sorted(int(f[5:13]) for f in os.listdir(
        worlds["dir"] / "ck2" / name) if f.startswith("step_"))
    assert steps[-1] == iters * (S + 1)
    assert any(s % (S + 1) for s in steps)      # mid-epoch cuts kept


def test_fatal_fault_stops_every_rank(worlds):
    got = [r["fatal"] for r in worlds["2"]]
    assert got[1].startswith("KeyError")
    assert got[0] == ("RankAbort: aborted with the faulted ranks: rank 1: "
                      "KeyError (not restartable)")


@pytest.mark.parametrize("world", ["2", "4"])
def test_replicated_backend_publishes_serving_snapshots(worlds, world):
    ranks = [r["published"] for r in worlds[world]]
    for r in ranks:
        snaps = r["snapshots"]
        assert [(it, cur, seq) for it, cur, seq, _ in snaps] == [
            (1, 0, 1), (2, 0, 2), (4, 0, 3), (4, 0, 4), (4, 0, 5)]
        assert all(np.array_equal(W, r["run"]["W"]) for *_, W in snaps[2:])
        assert np.array_equal(snaps[-1][3], ranks[0]["snapshots"][-1][3])


def test_token_values_do_not_depend_on_the_tile(monkeypatch):
    monkeypatch.setattr(llpt, "TILE_BYTES", 0)     # tiles of tile_size
    rng = np.random.default_rng(0)
    M, V, K, n = 30, 50, 16, 3000
    D = torch.from_numpy(rng.integers(0, 9, (M, K)).astype(np.int32))
    W = torch.from_numpy(rng.integers(0, 9, (V, K)).astype(np.int32))
    word = torch.from_numpy(rng.integers(0, V, n).astype(np.int32))
    doc = torch.from_numpy(rng.integers(0, M, n).astype(np.int32))
    kw = dict(alpha=0.3, beta=0.01, n_words=V)
    colsum = W.sum(dim=0, dtype=torch.float32)
    whole = llpt.token_ll(word, doc, D, W, colsum, tile_size=n, **kw)
    perm = torch.from_numpy(rng.permutation(n)[:777])
    for tile in (1, 7, 256):
        part = llpt.token_ll(word[perm], doc[perm], D, W, colsum,
                             tile_size=tile, **kw)
        assert torch.equal(part, whole[perm])
