"""The word-sharded parameter server (``w_sync="ps"``) against the
reference, on the CPU.

* The protocol. ``repro_torch.lda.ps`` is the reference's
  ``repro.lda.ps`` copied whole: every protocol case of
  ``tests/test_ps.py`` runs against both packages (``pkg``), one seeded
  random sequence of pulls, pushes, lost pushes, finishes, checkpoints,
  kills and revives leaves both servers and journals bitwise equal, and
  a ``ps_*`` payload packed by either package unpacks in the other.
* The trainer (``PSDistTrainer``, four workers in this process on the
  reference's PS corpus: 40 docs, 150 words, K = 16, shards padded to
  64). At ``staleness=0`` it is bitwise the port's single-device engine,
  dense and hybrid: topics, D, W, every LLPT; each owner holds at most
  0.35 of W's bytes. A mid-round payload resumes bitwise, restores at its
  cut in the port's single and replicated engines (redoing the round
  gives the uninterrupted run's counts), and its canonical part restores
  in the reference's single engine. Every drill of the reference's
  ``test_ps_chaos_drills_forged`` passes: bitwise, but the
  ``staleness=2`` run, whose clocks end aligned and whose counts pass
  ``selfcheck``. The engine routes ``w_sync="ps"`` to it, and a
  supervised shard-wise fit is bitwise the plain fit.
* Against the reference's own trainer: Ŵ's word stats of a page are the
  reference's ``_word_phase(page, colsum=...)`` (top indices bitwise,
  masses within ``_torch_parity``'s tolerance), and on a (1, 1) grid the
  two trainers' D and W are the histograms of their topics and their
  mean LLPT trajectories over 4 seeds agree within the engine tests'
  0.08 bits (the packages draw different random numbers).
* Every refusal keeps the reference's message.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.lda.ps as jps
import repro.checkpoint.ps_payload as jpay
import repro.runtime.chaos as jchaos
import repro_torch.lda.ps as tps
import repro_torch.checkpoint.ps_payload as tpay
import repro_torch.runtime.chaos as tchaos
from repro.lda.corpus import relabel_by_frequency, synthetic_lda_corpus
from repro_torch.lda.api import LDAEngine, SupervisePolicy
from repro_torch.lda.model import DistConfig, LDAConfig
import _torch_dist as td
from _torch_parity import MASS_RTOL, port_corpus

K = 16
GRID = (("data", 4), ("model", 1))
PAD = 64
LLPT_TOL = 0.08                    # tests/test_torch_engine.py
SEEDS = 4

PKGS = {"repro": types.SimpleNamespace(ps=jps, pay=jpay, chaos=jchaos),
        "repro_torch": types.SimpleNamespace(ps=tps, pay=tpay,
                                             chaos=tchaos)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# 1. the protocol, in both packages (tests/test_ps.py:56-258)
# ---------------------------------------------------------------------------

def _check_partition(layout) -> None:
    starts = layout.starts
    assert starts[0] == 0 and starts[-1] == layout.n_words
    assert all(b >= a for a, b in zip(starts, starts[1:]))
    covered = np.zeros(layout.n_words, np.int64)
    for o in range(layout.n_owners):
        a, b = layout.range_of(o)
        covered[a:b] += 1
    assert (covered == 1).all()
    for row in range(layout.n_words):
        a, b = layout.range_of(layout.owner_of(row))
        assert a <= row < b


def test_owner_partition_exact_seeded(pkg):
    rng = np.random.default_rng(0)
    for n_words, n_owners in [(1, 1), (1, 5), (7, 3), (100, 7), (150, 8),
                              (64, 64), (10, 16)]:
        _check_partition(pkg.ps.OwnerLayout.build(n_words, n_owners))
        mass = rng.zipf(1.8, size=n_words)
        _check_partition(pkg.ps.OwnerLayout.build(
            n_words, n_owners, layout="mass", row_mass=mass))


def test_owner_layouts_agree_across_packages():
    rng = np.random.default_rng(1)
    for n_words, n_owners in [(1, 1), (13, 4), (150, 8), (400, 12),
                              (10, 16)]:
        mass = rng.zipf(1.8, size=n_words)
        for kw in ({}, dict(layout="mass", row_mass=mass)):
            assert tps.OwnerLayout.build(n_words, n_owners, **kw).starts \
                == jps.OwnerLayout.build(n_words, n_owners, **kw).starts


def test_mass_layout_splits_hot_prefix(pkg):
    mass = 1.0 / (np.arange(200) + 1.0) ** 2
    rows = pkg.ps.OwnerLayout.build(200, 4, layout="rows")
    massy = pkg.ps.OwnerLayout.build(200, 4, layout="mass", row_mass=mass)
    assert (massy.starts[1] - massy.starts[0]) \
        < (rows.starts[1] - rows.starts[0])
    _check_partition(massy)


def test_owner_layout_rejects_bad_starts(pkg):
    with pytest.raises(ValueError, match="0..n_words"):
        pkg.ps.OwnerLayout(n_words=10, starts=(0, 5, 9))
    with pytest.raises(ValueError, match="non-decreasing"):
        pkg.ps.OwnerLayout(n_words=10, starts=(0, 7, 5, 10))
    with pytest.raises(ValueError, match="row_mass"):
        pkg.ps.OwnerLayout.build(10, 2, layout="mass", row_mass=np.ones(9))


def test_owners_touching_matches_owner_of(pkg):
    layout = pkg.ps.OwnerLayout.build(100, 7)
    for lo, hi in [(0, 100), (13, 14), (10, 60), (99, 100), (30, 30)]:
        want = sorted({layout.owner_of(r) for r in range(lo, hi)})
        assert layout.owners_touching(lo, hi) == want


V, KP = 20, 4


def _server(pkg, n_workers=2, n_owners=2, staleness=0, seed=0):
    layout = pkg.ps.OwnerLayout.build(V, n_owners)
    srv = pkg.ps.ParameterServer(layout, KP, n_workers, staleness=staleness)
    W = np.random.default_rng(seed).integers(0, 50, (V, KP)).astype(np.int32)
    srv.load_global(W)
    return srv, W


def test_round_commits_only_when_all_workers_finish(pkg):
    srv, W = _server(pkg)
    a, b = pkg.ps.PSClient(srv, 0), pkg.ps.PSClient(srv, 1)
    d = np.ones((V, KP), np.int32)
    a.push_page(0, V, d)
    a.finish_round()
    assert srv.committed == 0
    assert np.array_equal(b.pull_page(0, V), W)
    b.push_page(0, V, 2 * d)
    b.finish_round()
    assert srv.committed == 1
    assert np.array_equal(a.pull_page(0, V), W + 3)
    assert np.array_equal(srv.gather_global(), W + 3)


def test_staleness_gate(pkg):
    srv, _ = _server(pkg, n_workers=2, staleness=1)
    fast, slow = pkg.ps.PSClient(srv, 0), pkg.ps.PSClient(srv, 1)
    for _ in range(2):
        fast.push_page(0, V, np.ones((V, KP), np.int32))
        fast.finish_round()
    assert srv.can_pull(1) and not srv.can_pull(2)
    assert not fast.can_advance()
    with pytest.raises(pkg.ps.StalenessViolation):
        fast.pull_page(0, V)
    with pytest.raises(pkg.ps.StalenessViolation):
        srv.pull_colsum(clock=2)
    assert slow.can_advance()


def test_staleness_zero_pulls_see_exactly_committed(pkg):
    srv, W = _server(pkg, staleness=0)
    c0, c1 = pkg.ps.PSClient(srv, 0), pkg.ps.PSClient(srv, 1)
    c0.push_page(0, 10, np.full((10, KP), 3, np.int32))
    assert np.array_equal(c0.pull_page(0, 10), W[:10])
    c0.finish_round()
    c1.finish_round()
    assert np.array_equal(c0.pull_page(0, 10), W[:10] + 3)


def test_duplicate_push_acks_without_reapplying(pkg):
    srv, W = _server(pkg, n_workers=1)
    blk = np.ones((5, KP), np.int32)
    assert srv.push_page(0, 0, 7, 0, 5, blk)
    assert srv.push_page(0, 0, 7, 0, 5, blk)
    srv.finish_round(0, 0)
    assert np.array_equal(srv.gather_global()[:5], W[:5] + 1)


def test_colsum_is_exact_int(pkg):
    srv, W = _server(pkg, n_owners=3)
    assert np.array_equal(srv.pull_colsum(clock=0),
                          W.sum(axis=0).astype(np.int32))


def test_journal_accumulates_per_owner_and_trims(pkg):
    j = pkg.ps.PushJournal(0, pkg.ps.OwnerLayout.build(V, 2), KP)
    j.record(0, 5, 15, np.ones((10, KP), np.int32))
    j.record(0, 8, 18, np.ones((10, KP), np.int32))
    b0, b1 = j.blocks_for(0, 0), j.blocks_for(0, 1)
    assert b0.shape == (10, KP) and b1.shape == (10, KP)
    assert int(b0.sum() + b1.sum()) == 2 * 10 * KP
    assert j.nbytes() > 0
    j.trim(0)
    assert j.blocks_for(0, 0) is None and j.nbytes() == 0


def test_note_checkpoint_requires_committed_clock(pkg):
    srv, _ = _server(pkg)
    with pytest.raises(ValueError, match="committed"):
        srv.note_checkpoint(3, journals=())


@pytest.mark.chaos
def test_lost_push_resent_from_journal(pkg):
    srv, W = _server(pkg, n_workers=1)
    c = pkg.ps.PSClient(srv, 0)
    with pkg.chaos.active(pkg.chaos.FaultPlan(ps_lose_pushes=((0, 0),))):
        c.push_page(0, V, np.ones((V, KP), np.int32))
        c.finish_round()
    assert np.array_equal(srv.gather_global(), W + 1)
    assert c.journal.next_seq == 1


@pytest.mark.chaos
def test_owner_kill_revive_replays_journals(pkg):
    srv, W = _server(pkg, n_workers=2, n_owners=2)
    a, b = pkg.ps.PSClient(srv, 0), pkg.ps.PSClient(srv, 1)
    for c in (a, b):
        c.push_page(0, V, np.ones((V, KP), np.int32))
        c.finish_round()
    a.push_page(0, V, np.full((V, KP), 5, np.int32))
    srv.kill_owner(1)
    with pytest.raises(RuntimeError, match="dead"):
        b.pull_page(0, V)
    with pytest.raises(RuntimeError, match="dead"):
        b.pull_colsum()
    srv.revive_owner(1, journals=[a.journal, b.journal])
    assert np.array_equal(srv.gather_global(), W + 2)
    a.finish_round()
    b.finish_round()
    assert np.array_equal(srv.gather_global(), W + 7)


@pytest.mark.chaos
def test_revive_requires_all_journals_and_live_owner_check(pkg):
    srv, _ = _server(pkg, n_workers=2)
    with pytest.raises(ValueError, match="not dead"):
        srv.revive_owner(0, journals=[None, None])
    srv.kill_owner(0)
    with pytest.raises(ValueError, match="journals"):
        srv.revive_owner(0, journals=[None])


def test_owner_bytes_are_a_fraction_of_global(pkg):
    srv = pkg.ps.ParameterServer(pkg.ps.OwnerLayout.build(4096, 8), 64, 4)
    assert srv.max_owner_nbytes() <= 4096 * 64 * 4 / 8 + 64 * 4


def _snapshot(srv, clients) -> dict:
    """Every field of a server and its clients' journals."""
    return {"rows": [r.copy() for r in srv.rows],
            "committed": srv.committed,
            "pending": {c: {o: b.copy() for o, b in per.items()}
                        for c, per in srv.pending.items()},
            "finished": {c: set(v) for c, v in srv.finished.items()},
            "seen": {c: set(v) for c, v in srv.seen.items()},
            "dead": set(srv.dead), "ckpt_clock": srv.ckpt_clock,
            "ckpt_rows": [r.copy() for r in srv.ckpt_rows],
            "max_owner_nbytes": srv.max_owner_nbytes(),
            "journals": [({c: {o: b.copy() for o, b in per.items()}
                           for c, per in cl.journal.rounds.items()},
                          cl.journal.next_seq, cl.journal.nbytes(),
                          cl.clock) for cl in clients]}


def _assert_same(a, b, where) -> None:
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _play(pkg, seed: int, n_ops: int = 160) -> list:
    """A seeded random protocol run; returns the snapshot after each op
    and the outcome of each pull."""
    rng = np.random.default_rng(seed)
    n_workers, n_owners = 3, 4
    layout = pkg.ps.OwnerLayout.build(
        V, n_owners, layout="mass", row_mass=rng.integers(0, 9, V))
    srv = pkg.ps.ParameterServer(layout, KP, n_workers, staleness=1)
    srv.load_global(rng.integers(0, 40, (V, KP)).astype(np.int32))
    clients = [pkg.ps.PSClient(srv, w) for w in range(n_workers)]
    log = []
    for step in range(n_ops):
        op = rng.choice(["pull", "push", "lost", "finish", "ckpt", "kill"],
                        p=[0.2, 0.35, 0.1, 0.2, 0.07, 0.08])
        c = clients[int(rng.integers(n_workers))]
        lo = int(rng.integers(0, V))
        hi = int(rng.integers(lo, V + 1))
        out = None
        if op == "pull":
            try:
                out = (c.pull_page(lo, hi), c.pull_colsum())
            except (pkg.ps.StalenessViolation, RuntimeError) as exc:
                out = type(exc).__name__
        elif op in ("push", "lost") and c.can_advance():
            blk = rng.integers(-3, 4, (hi - lo, KP)).astype(np.int32)
            plan = pkg.chaos.FaultPlan(
                ps_lose_pushes=((c.worker, c.clock),) if op == "lost" else ())
            with pkg.chaos.active(plan):
                c.push_page(lo, hi, blk)
        elif op == "finish" and c.can_advance():
            c.finish_round()
        elif op == "ckpt":
            srv.note_checkpoint(srv.committed,
                                journals=[x.journal for x in clients])
        elif op == "kill":
            o = int(rng.integers(n_owners))
            srv.kill_owner(o)
            srv.revive_owner(o, [x.journal for x in clients])
        log.append((str(op), out, _snapshot(srv, clients)))
    return log


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_protocol_runs_are_bitwise_equal(seed):
    want, got = _play(PKGS["repro"], seed), _play(PKGS["repro_torch"], seed)
    assert any(op == "kill" for op, _, _ in want)
    for i, (a, b) in enumerate(zip(want, got)):
        _assert_same(a, b, f"op {i} ({a[0]})")


@pytest.mark.parametrize("packer,unpacker", [("repro", "repro_torch"),
                                             ("repro_torch", "repro")])
def test_ps_payload_interchanges(packer, unpacker):
    a, b = PKGS[packer], PKGS[unpacker]
    srv, W = _server(a, n_workers=3, n_owners=3)
    epochs = [types.SimpleNamespace(stat_sums=np.arange(4.0) + w,
                                    n_surv=10.0 * w) if w != 1 else None
              for w in range(3)]
    packed = a.pay.pack_ps_payload(
        server=srv, cursors=np.array([2, 0, 1]),
        done_topics=np.arange(30, dtype=np.int32), epochs=epochs)
    ext = b.pay.unpack_ps_payload(packed)
    assert ext.clock == 0 and np.array_equal(ext.cursors, [2, 0, 1])
    assert np.array_equal(ext.done_topics, np.arange(30))
    assert np.array_equal(ext.gather_w(), W)
    assert np.array_equal(ext.stat_sums[2], np.arange(4.0) + 2)
    assert np.array_equal(ext.n_surv, [0.0, 0.0, 20.0])
    assert b.pay.unpack_ps_payload({"topics_global": 0}) is None
    assert a.pay.PS_PAYLOAD_PREFIX == b.pay.PS_PAYLOAD_PREFIX == "ps_"
    del packed["ps_w_owner_00002"]
    with pytest.raises(ValueError, match="lacks ps_w_owner_00002"):
        b.pay.unpack_ps_payload(packed)


# ---------------------------------------------------------------------------
# 2. the port's trainer (tests/test_ps.py:343-498)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_corpus():
    c = synthetic_lda_corpus(3, n_docs=40, n_words=150, n_topics=K,
                             mean_doc_len=75)
    return relabel_by_frequency(c)[0]


@pytest.fixture(scope="module")
def corpus(ref_corpus):
    return port_corpus(ref_corpus)


FORMATS = {"dense": {}, "hybrid": dict(format="hybrid",
                                       tail_sampler="sparse")}


def _cfg(fmt="dense", ps=True, **dist):
    kw = dict(n_topics=K, seed=11, tile_size=256, fused=True, eval_every=1,
              **FORMATS[fmt])
    if ps:
        kw["dist"] = DistConfig(w_sync="ps", mesh_shape=GRID, **dist)
    return LDAConfig(**kw)


def _ps(corpus, fmt="dense", **dist):
    return LDAEngine(corpus, _cfg(fmt, **dist), device="cpu",
                     pad_multiple=PAD).trainer


def _counts(tr, ss):
    D, W = tr.gather_global(ss)
    return D.numpy(), W.numpy()


@pytest.fixture(scope="module")
def singles(corpus):
    """The port's single-device engine, 4 iterations, each format."""
    out = {}
    for fmt in FORMATS:
        eng = LDAEngine(corpus, _cfg(fmt, ps=False), device="cpu",
                        backend="single")
        hist = eng.fit(4)
        out[fmt] = {"topics": eng.host_payload()["topics_global"],
                    "D": eng.state.D.numpy(), "W": eng.state.W.numpy(),
                    "llpt": hist["llpt"]}
    return out


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_staleness0_is_bitwise_single(corpus, singles, fmt):
    eng = LDAEngine(corpus, _cfg(fmt), device="cpu", pad_multiple=PAD)
    assert eng.backend_name == "distributed" and eng._backend.is_ps
    hist = eng.fit(4)
    tr, want = eng.trainer, singles[fmt]
    D, W = _counts(tr, eng.state)
    assert np.array_equal(D, want["D"]) and np.array_equal(W, want["W"])
    assert np.array_equal(eng.host_payload()["topics_global"], want["topics"])
    assert hist["llpt"] == want["llpt"]
    assert eng.iteration == 4 and eng.score() == want["llpt"][-1]
    assert np.array_equal(eng.export().W, want["W"])
    tr.selfcheck(eng.state)
    assert eng.state.overflow == 0
    assert eng.state.server.max_owner_nbytes() <= 0.35 * W.nbytes
    assert eng.state_nbytes() < D.nbytes + W.nbytes


def test_mid_round_payload_resumes_and_interchanges(corpus, singles,
                                                    ref_corpus, tmp_path):
    from repro.lda.api import LDAEngine as JaxEngine
    from repro.lda.model import LDAConfig as JaxConfig
    want = singles["dense"]
    t1 = _ps(corpus)
    s1, _ = t1.run_fused(t1.init_state(), 2)
    s1 = t1.run_shards(s1, 2)                 # 2 sub-shards into round 2
    assert s1.cursors.all() and s1.iteration == 2
    pay = t1.host_payload(s1)
    assert "ps_cursors" in pay and pay["iteration"] == 2
    t1b = _ps(corpus)
    s1b, _ = t1b.run_fused(t1b.state_from_payload(pay), 2)
    s1, _ = t1.run_fused(s1, 2)
    for a, b in zip(_counts(t1, s1), _counts(t1b, s1b)):
        assert np.array_equal(a, b)
    assert np.array_equal(_counts(t1, s1)[1], want["W"])
    assert np.array_equal(_counts(t1, s1)[0], want["D"])
    # the port's single engine: restores at the cut, redoes the round
    single = LDAEngine(corpus, _cfg(ps=False), device="cpu",
                       backend="single").restore(pay)
    assert single.iteration == 2
    single.fit(2)
    assert np.array_equal(single.state.W.numpy(), want["W"])
    assert np.array_equal(single.state.D.numpy(), want["D"])
    # the port's replicated engine, likewise
    with td.world1(tmp_path):
        rep = LDAEngine(corpus, _cfg(ps=False), device="cpu",
                        backend="distributed", pad_multiple=PAD)
        rep.restore(pay)
        rep.fit(2)
        D, W = rep.trainer.gather_global(rep.state)
        assert np.array_equal(W.numpy(), want["W"])
        assert np.array_equal(D.numpy(), want["D"])
        # and its boundary payload back into the parameter server
        t5 = _ps(corpus)
        s5 = t5.state_from_payload(rep.host_payload())
    assert s5.iteration == 4
    assert np.array_equal(_counts(t5, s5)[1], want["W"])
    # the canonical part in the reference's single engine
    jeng = JaxEngine(ref_corpus, JaxConfig(n_topics=K, seed=11,
                                           tile_size=256, fused=True),
                     backend="single")
    jeng.restore({k: pay[k] for k in ("topics_global", "key", "iteration")})
    assert jeng.iteration == 2
    D2, W2 = _counts(t1b, t1b.state_from_payload(
        {k: pay[k] for k in ("topics_global", "key", "iteration")}))
    assert np.array_equal(np.asarray(jeng.state.W), W2)
    assert np.array_equal(np.asarray(jeng.state.D), D2)


@pytest.mark.chaos
def test_chaos_drills(corpus, singles):
    """The reference's ``test_ps_chaos_drills_forged``, on the port."""
    refD, refW = singles["dense"]["D"], singles["dense"]["W"]

    def same(tr, ss):
        D, W = _counts(tr, ss)
        return np.array_equal(W, refW) and np.array_equal(D, refD)

    # owner kill after a checkpoint: revive = snapshot + journal replay
    t3 = _ps(corpus, n_owners=3)
    s3, _ = t3.run_fused(t3.init_state(), 1)
    t3.host_payload(s3)
    with tchaos.active(tchaos.FaultPlan(ps_kill_owners=((1, 3),))) as plan:
        s3, _ = t3.run_fused(s3, 3)
    assert ("ps_kill", (1, 3)) in plan._fired
    assert same(t3, s3)
    # lost pushes: the client resends from its journal until acked
    t4 = _ps(corpus)
    with tchaos.active(tchaos.FaultPlan(
            ps_lose_pushes=((2, 1), (0, 3)))) as plan:
        s4, _ = t4.run_fused(t4.init_state(), 4)
    assert len(plan._fired) == 2
    assert same(t4, s4)
    # staleness=2 and a slow worker: stale pulls within the bound
    t2 = _ps(corpus, staleness=2)
    with tchaos.active(tchaos.FaultPlan(ps_slow_workers={0: 2})):
        s2, _ = t2.run_fused(t2.init_state(), 4)
    assert int(s2.clocks.min()) == 4 and int(s2.clocks.max()) == 4
    t2.selfcheck(s2)
    assert not same(t2, s2)                # the pulls were stale indeed
    # a mid-round checkpoint, an owner kill, and a restore from the cut
    t6 = _ps(corpus, n_owners=3)
    s6, _ = t6.run_fused(t6.init_state(), 2)
    s6 = t6.run_shards(s6, 2)
    pay = t6.host_payload(s6)
    with tchaos.active(tchaos.FaultPlan(ps_kill_owners=((2, 2),))) as plan:
        s6, _ = t6.run_fused(s6, 2)
    assert ("ps_kill", (2, 2)) in plan._fired
    t6b = _ps(corpus, n_owners=3)
    s6b, _ = t6b.run_fused(t6b.state_from_payload(pay), 2)
    assert same(t6, s6) and same(t6b, s6b)


def test_supervised_shardwise_fit_is_bitwise_plain(corpus, tmp_path):
    cfg = dataclasses.replace(_cfg(), eval_every=2)
    eng = LDAEngine(corpus, cfg, device="cpu", pad_multiple=PAD)
    plain = eng.fit(4)
    W_ref = eng.export().W
    sup = LDAEngine(corpus, cfg, device="cpu", pad_multiple=PAD,
                    checkpoint_dir=str(tmp_path))
    hist = sup.fit(4, supervise=SupervisePolicy(checkpoint_shards=1))
    assert np.array_equal(sup.export().W, W_ref)
    assert hist["iteration"] == plain["iteration"]
    assert hist["llpt"] == plain["llpt"]
    assert hist["restart_report"].completed_steps == 4
    R = sup.trainer._R
    keys = sorted(int(p.name[5:13]) for p in tmp_path.iterdir())
    # the newest: round 4's boundary, and before it round 3's last cut
    assert keys[-2:] == [3 * (R + 1) + R - 1, 4 * (R + 1)]


@pytest.mark.chaos
def test_supervised_fit_recovers_from_a_kill(corpus, singles, tmp_path):
    """A raise mid-run: the supervised PS fit restarts from its newest
    checkpoint (a mid-round one under checkpoint_shards) and ends bitwise
    the undisturbed run."""
    from repro_torch.runtime.fault import SupervisePolicy as Policy
    for shards, plan in ((None, tchaos.FaultPlan(raise_at_steps=(2,))),
                         (1, tchaos.FaultPlan(raise_at_shards=((2, 5),)))):
        d = tmp_path / f"s{shards}"
        eng = LDAEngine(corpus, _cfg(), device="cpu", pad_multiple=PAD,
                        checkpoint_dir=str(d))
        with tchaos.active(plan):
            hist = eng.fit(4, supervise=Policy(
                checkpoint_every=1, checkpoint_shards=shards,
                backoff_base=0.0, straggler_z=1e9))
        rep = hist["restart_report"]
        assert rep.restarts == 1 and rep.completed_steps == 4, rep
        D, W = _counts(eng.trainer, eng.state)
        assert np.array_equal(W, singles["dense"]["W"])
        assert np.array_equal(D, singles["dense"]["D"])


def test_refusals_keep_the_reference_messages(corpus, tmp_path):
    from repro_torch.lda.distributed import PSDistTrainer
    grid = {"data": 2, "model": 1}

    def trainer(cfg, g=grid, **kw):
        return PSDistTrainer(corpus, cfg, g, device="cpu", **kw)

    ps = DistConfig(w_sync="ps")
    kw = dict(n_topics=8, tile_size=256)
    cases = [
        (lambda: trainer(LDAConfig(**kw, dist=ps)), TypeError,
         "engine-internal backend"),
        (lambda: trainer(LDAConfig(**kw, dist=ps), {"data": 2},
                         _from_engine=True), ValueError,
         "lack a 'model' axis"),
        (lambda: trainer(LDAConfig(**kw, dist=ps), {"data": 1, "model": 2},
                         _from_engine=True), ValueError,
         "w_sync='ps' needs a model mesh axis of size 1"),
        (lambda: trainer(LDAConfig(**kw, dist=DistConfig(
            w_sync="ps", balance="tiles")), _from_engine=True), ValueError,
         "w_sync='ps' requires balance='none'"),
        (lambda: trainer(LDAConfig(**kw, sampler="warp", dist=ps),
                         _from_engine=True), ValueError,
         "sampler='warp' is single-backend only"),
        (lambda: trainer(LDAConfig(**kw, corpus_residency="disk",
                                   corpus_path=str(tmp_path), dist=ps),
                         _from_engine=True), ValueError,
         "the disk-native corpus store is not yet plumbed"),
        (lambda: LDAEngine(corpus, LDAConfig(**kw, dist=ps), device="cpu",
                           backend="single"), ValueError,
         "parameter server"),
        (lambda: LDAEngine(corpus, LDAConfig(**kw, dist=DistConfig(
            w_sync="ps", mesh_shape=GRID)), device="cpu",
            mesh=types.SimpleNamespace(shape={"data": 4, "model": 1})),
         ValueError, "pass mesh= OR DistConfig.mesh_shape"),
    ]
    for fn, kind, match in cases:
        with pytest.raises(kind, match=match.replace("(", r"\(")):
            fn()
    tr = _ps(corpus)
    with pytest.raises(ValueError, match="advances by whole rounds"):
        tr.step(tr.init_state())
    ss = tr.run_shards(tr.init_state(), 1)
    ss.clocks[0] += 1
    with pytest.raises(ValueError, match="aligned clock"):
        tr.host_payload(ss)
    with pytest.raises(ValueError, match="single-host backend only"):
        tr.state_from_payload({"topics_global": np.zeros(corpus.n_tokens),
                               "iteration": 0, "stream_cursor": 1})
    # a payload whose owner rows disagree with its topics
    t = _ps(corpus)
    s = t.run_shards(t.init_state(), 1)
    pay = t.host_payload(s)
    pay["ps_w_owner_00000"] = pay["ps_w_owner_00000"] + 1
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        _ps(corpus).state_from_payload(pay)


def test_worker_grid_defaults(corpus):
    """The grid: mesh_shape, else mesh='s shape, else one worker a visible
    device of the engine's device type (the CPU counts as one)."""
    eng = LDAEngine(corpus, LDAConfig(n_topics=8, dist=DistConfig(
        w_sync="ps")), device="cpu", pad_multiple=PAD)
    assert eng.trainer.grid == {"data": 1, "model": 1}
    eng = LDAEngine(corpus, LDAConfig(n_topics=8, dist=DistConfig(
        w_sync="ps")), device="cpu", pad_multiple=PAD,
        mesh=types.SimpleNamespace(shape={"pod": 2, "data": 3, "model": 1}))
    assert eng.trainer.sc.n_shards == 6


# ---------------------------------------------------------------------------
# 3. against the reference's trainer
# ---------------------------------------------------------------------------

def test_word_phase_of_a_page_matches_the_reference(corpus, singles):
    """Ŵ's top-(g+1) and Q' of a page of W rows with the global column
    sum: the port's (``word_stats`` of the page) against the reference's
    ``_word_phase(page, colsum=...)`` on a (1, 1) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.lda.distributed import _word_phase
    from repro.lda.model import LDAConfig as JaxConfig
    from repro.runtime.compat import make_mesh, shard_map
    from repro_torch.core import esca, three_branch
    W = singles["dense"]["W"]
    colsum = W.sum(axis=0).astype(np.int32)
    cfg = JaxConfig(n_topics=K)
    V, g = W.shape[0], cfg.g
    mesh = make_mesh((1, 1), ("data", "model"))
    for lo, hi in ((0, V), (5, 47), (100, V), (17, 19)):
        page = W[lo:hi]
        fn = shard_map(
            lambda p, c: _word_phase(p, cfg=cfg, model_axis="model",
                                     n_words=V, g=g, kb0=0, k_local=K,
                                     colsum=c),
            mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P(), P(), P()),
            check_vma=False)
        _, j_vals, j_idx, j_q = (np.asarray(x) for x in jax.jit(fn)(
            jnp.asarray(page), jnp.asarray(colsum, jnp.float32)))
        w_hat = esca.compute_w_hat_from_colsum(
            torch.from_numpy(page), torch.from_numpy(colsum), cfg.beta,
            n_words=V)
        st = three_branch.word_stats(w_hat, g=g, alpha=cfg.alpha_)
        assert np.array_equal(st.k.numpy(), j_idx[:, :g])
        np.testing.assert_allclose(st.a.numpy(), j_vals, rtol=MASS_RTOL)
        np.testing.assert_allclose(st.q_prime.numpy(), j_q, rtol=MASS_RTOL)
        # and the page's rows are the full matrix's, bit for bit
        full = three_branch.word_stats(esca.compute_w_hat_from_colsum(
            torch.from_numpy(W), torch.from_numpy(colsum), cfg.beta),
            g=g, alpha=cfg.alpha_)
        for f in ("a", "k", "q_prime"):
            assert torch.equal(getattr(st, f), getattr(full, f)[lo:hi]), f


def test_trajectory_matches_the_reference_trainer(ref_corpus, corpus):
    """A reference ``PSDistTrainer`` on a (1, 1) mesh and the port's on a
    (1, 1) grid: D and W the histograms of their topics, and mean LLPT
    trajectories over SEEDS seeds within LLPT_TOL."""
    import jax.numpy as jnp
    from repro.core import llpt as jllpt
    from repro.lda.distributed import PSDistTrainer as JaxPS
    from repro.lda.model import DistConfig as JaxDist
    from repro.lda.model import LDAConfig as JaxConfig
    from repro.runtime.compat import make_mesh
    from repro_torch.lda.distributed import PSDistTrainer
    kw = dict(n_topics=K, tile_size=256, stream_shards=3)
    jcfg = JaxConfig(**kw, dist=JaxDist(w_sync="ps"))
    jtr = JaxPS(ref_corpus, jcfg, make_mesh((1, 1), ("data", "model")),
                pad_multiple=PAD, _from_engine=True)
    c = ref_corpus
    marks = (1, 4, 8, 12)

    def histograms(topics):
        D = np.zeros((c.n_docs, K), np.int64)
        W = np.zeros((c.n_words, K), np.int64)
        np.add.at(D, (c.doc_ids, topics), 1)
        np.add.at(W, (c.word_ids, topics), 1)
        return D, W

    ref, got = [], []
    for seed in range(SEEDS):
        jtr.cfg = dataclasses.replace(jcfg, seed=seed)
        ttr = PSDistTrainer(corpus, LDAConfig(**kw, seed=seed, dist=DistConfig(
            w_sync="ps")), {"data": 1, "model": 1}, PAD, device="cpu",
            _from_engine=True)
        js, ts, done, ll_j, ll_t = jtr.init_state(), ttr.init_state(), 0, \
            [], []
        for m in marks:
            js, _ = jtr.run_fused(js, m - done)
            ts, _ = ttr.run_fused(ts, m - done)
            done = m
            D, W = jtr.gather_global(js)
            ll_j.append(float(jllpt.llpt(
                jnp.asarray(c.word_ids), jnp.asarray(c.doc_ids),
                jnp.ones(c.n_tokens, jnp.int32), jnp.asarray(D, jnp.int32),
                jnp.asarray(W), alpha=jcfg.alpha_, beta=jcfg.beta,
                tile_size=256)))
            ll_t.append(ttr.evaluate(ts))
        for tr, st in ((jtr, js), (ttr, ts)):
            D, W = (np.asarray(x) for x in (tr.gather_global(st)
                                            if tr is jtr else
                                            _counts(tr, st)))
            hD, hW = histograms(tr.host_payload(st)["topics_global"])
            assert np.array_equal(D, hD) and np.array_equal(W, hW)
        ref.append(ll_j)
        got.append(ll_t)
    ref, got = np.mean(ref, axis=0), np.mean(got, axis=0)
    assert np.all(np.abs(got - ref) <= LLPT_TOL), (got, ref)
    assert np.all(np.diff(got) > 0)
