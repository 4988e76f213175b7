"""The port's checkpoints against the reference's.

* ``repro_torch.checkpoint.CheckpointManager``: the reference's recovery
  cases (``tests/test_checkpoint_recovery.py``) against the port's copy,
  and files written by either package read by the other, checksum
  accepted.
* The canonical payload ``{topics_global, key, iteration}`` crosses both
  ways: a JAX engine's checkpoint resumes in the port with its topics,
  iteration and counts; a port checkpoint resumes in the JAX engine.
* Inside the port a resumed run is bitwise the uninterrupted one (dense,
  hybrid + tiles, warp), and ``fit(checkpoint_every=)`` saves at the
  boundaries.
* The restore path's repairs: a legacy padded payload restores; a
  mid-epoch streamed payload and a malformed one raise ``ValueError``.

Tolerance: bitwise everywhere (integer topics and counts, the payload
arrays, the checksum); LLPT of a resumed run equal to the float.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint.manager import _checksum as jax_checksum
from repro.core import esca as jesca
from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.corpus import synthetic_lda_corpus
from repro.lda.model import LDAConfig as JaxConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _checksum
from repro_torch.lda import LDAEngine, LDATrainer
from repro_torch.lda.api import FrozenLDAModel
from repro_torch.lda.convert import key_data
from repro_torch.lda.model import LDAConfig
from _torch_parity import port_corpus

KW = dict(n_topics=16, tile_size=512, eval_every=5)


@pytest.fixture(scope="module")
def corpus():
    # raw (unrelabeled) on purpose: both engines own corpus prep
    return synthetic_lda_corpus(0, n_docs=60, n_words=80, n_topics=8,
                                mean_doc_len=40)


# ---------------------------------------------------------------------------
# the manager: the reference's recovery cases, and cross-reads
# ---------------------------------------------------------------------------

def _save_steps(m, steps):
    for s in steps:
        m.save(s, {"x": np.arange(8) + s, "iteration": np.int64(s)})


def _path(d, step):
    return os.path.join(str(d), f"step_{step:08d}.npz")


def _truncate(d, step, size):
    with open(_path(d, step), "r+b") as f:
        f.truncate(size)


def _empty_dir(d):
    m = CheckpointManager(str(d))
    assert m.restore_latest() is None and m.all_steps() == []


def _truncated_newest(d):
    m = CheckpointManager(str(d), keep_n=5)
    _save_steps(m, (1, 2, 3))
    _truncate(d, 3, 10)                  # not even a zip header survives
    assert int(m.restore_latest()["iteration"]) == 2


def _torn_zip(d):
    m = CheckpointManager(str(d), keep_n=5)
    _save_steps(m, (1, 2))
    _truncate(d, 2, os.path.getsize(_path(d, 2)) // 2)
    assert int(m.restore_latest()["iteration"]) == 1


def _checksum_mismatch(d):
    m = CheckpointManager(str(d), keep_n=5)
    _save_steps(m, (1,))
    arrs = {"x": np.arange(8) + 2, "iteration": np.int64(2)}
    arrs["__checksum__"] = np.frombuffer(
        _checksum({"x": np.zeros(8)}).encode(), dtype=np.uint8)
    np.savez(_path(d, 2), **arrs)
    assert m.restore(2) is None
    assert int(m.restore_latest()["iteration"]) == 1


def _all_corrupt(d):
    m = CheckpointManager(str(d), keep_n=5)
    _save_steps(m, (1, 2))
    for s in (1, 2):
        _truncate(d, s, 5)
    assert m.restore_latest() is None


def _walk_back_reports(d):
    m = CheckpointManager(str(d), keep_n=5)
    _save_steps(m, (1, 2, 3))
    for s in (2, 3):
        _truncate(d, s, 12)
    lines = []
    assert int(m.restore_latest(log_fn=lines.append)["iteration"]) == 1
    assert len(lines) == 2 and all("walking back" in ln for ln in lines)
    assert any("step 3" in ln for ln in lines)
    assert any("step 2" in ln for ln in lines)


def _validate_gate(d):
    m = CheckpointManager(str(d), keep_n=5)
    m.save(1, {"x": np.arange(8), "iteration": np.int64(1)})
    m.save(2, {"x": np.arange(8), "iteration": np.int64(2),
               "stream_n_shards": np.int64(8)})
    lines = []
    back = m.restore_latest(
        log_fn=lines.append,
        validate=lambda p: int(p.get("stream_n_shards", 4)) == 4)
    assert int(back["iteration"]) == 1
    assert len(lines) == 1 and "semantic validation" in lines[0]

    def explode(payload):
        raise KeyError("stream_n_shards")
    assert m.restore_latest(validate=explode) is None
    assert int(m.restore_latest()["iteration"]) == 2


def _survives_reopen(d):
    m = CheckpointManager(str(d), keep_n=2)
    _save_steps(m, (1, 2, 3))
    m2 = CheckpointManager(str(d), keep_n=2)
    assert m2.all_steps() == [2, 3]
    assert int(m2.restore_latest()["iteration"]) == 3


def _orphan_tmp_swept(d):
    m = CheckpointManager(str(d))
    orphan = os.path.join(str(d), ".tmp-deadbeef")
    with open(orphan, "wb") as f:
        f.write(b"half a checkpoint")
    _save_steps(m, (1,))
    assert not os.path.exists(orphan)
    assert int(m.restore_latest()["iteration"]) == 1


_CASES = {f.__name__.lstrip("_"): f for f in (
    _empty_dir, _truncated_newest, _torn_zip, _checksum_mismatch,
    _all_corrupt, _walk_back_reports, _validate_gate, _survives_reopen,
    _orphan_tmp_swept)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_manager_recovery_cases(case, tmp_path):
    """The reference's on-disk damage drills, against the port's manager."""
    _CASES[case](tmp_path)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_manager_files_cross_read(writer, tmp_path):
    """A file either package writes restores in the other: same name,
    same arrays, and a checksum the reader accepts."""
    W, R = (JaxManager, CheckpointManager) if writer == "reference" \
        else (CheckpointManager, JaxManager)
    payload = {"topics_global": np.arange(11, dtype=np.int32),
               "key": key_data(3), "iteration": 7}
    path = W(str(tmp_path)).save(7, payload)
    assert os.path.basename(path) == "step_00000007.npz"
    got = R(str(tmp_path)).restore_latest()
    assert got is not None and sorted(got) == sorted(payload)
    for k, v in payload.items():
        assert np.array_equal(got[k], np.asarray(v))
        assert got[k].dtype == np.asarray(v).dtype
    arrs = {k: np.asarray(v) for k, v in payload.items()}
    assert _checksum(arrs) == jax_checksum(arrs)


# ---------------------------------------------------------------------------
# the canonical payload across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_key_layout_is_prngkey_data(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    got = key_data(seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_jax_checkpoint_resumes_in_the_port(corpus, tmp_path):
    """A JAX engine fits and saves; the port resumes its checkpoint with
    the same iteration and topics, and D/W bitwise the reference's
    ``esca.update_counts`` of those topics."""
    jeng = JaxEngine(corpus, JaxConfig(fused=True, **KW), backend="single",
                     checkpoint_dir=str(tmp_path))
    jeng.fit(3)
    jeng.save()
    teng = LDAEngine(port_corpus(corpus), LDAConfig(fused=True, **KW),
                     device="cpu", checkpoint_dir=str(tmp_path)).resume()
    assert teng.iteration == 3
    n = teng.corpus.n_tokens
    jp = jeng.host_payload()
    assert np.array_equal(teng.state.topics.numpy()[:n], jp["topics_global"])
    tr = jeng.trainer
    D, W = jesca.update_counts(tr.word_ids, tr.doc_ids,
                               teng.state.topics.numpy(), tr.mask,
                               n_docs=tr.n_docs, n_words=tr.n_words,
                               n_topics=KW["n_topics"])
    assert np.array_equal(teng.state.D.numpy(), np.asarray(D))
    assert np.array_equal(teng.state.W.numpy(), np.asarray(W))
    teng.fit(2)                              # and trains on from there
    assert teng.iteration == 5


def test_port_checkpoint_resumes_in_jax(corpus, tmp_path):
    """A port checkpoint (with the key) resumes in the JAX engine, whose
    payload then carries the port's topics bitwise, and trains on."""
    teng = LDAEngine(port_corpus(corpus), LDAConfig(fused=True, seed=4, **KW),
                     device="cpu", checkpoint_dir=str(tmp_path))
    teng.fit(3)
    teng.save()
    jeng = JaxEngine(corpus, JaxConfig(fused=True, seed=4, **KW),
                     backend="single", checkpoint_dir=str(tmp_path)).resume()
    assert jeng.iteration == 3
    jp, tp = jeng.host_payload(), teng.host_payload()
    assert np.array_equal(jp["topics_global"], tp["topics_global"])
    assert np.array_equal(jp["key"], tp["key"])
    assert np.array_equal(np.asarray(jeng.state.W), teng.state.W.numpy())
    jeng.fit(1)
    assert jeng.iteration == 4


# ---------------------------------------------------------------------------
# resume inside the port
# ---------------------------------------------------------------------------

class _Recording(CheckpointManager):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.saved = []

    def save(self, step, payload):
        self.saved.append(step)
        return super().save(step, payload)


@pytest.mark.parametrize("over", [
    dict(), dict(format="hybrid", tail_sampler="sparse", balance="tiles"),
    dict(sampler="warp", eval_every=1), dict(fused=False)],
    ids=["dense", "hybrid_tiles", "warp", "stepwise"])
def test_resume_is_bitwise_the_uninterrupted_run(corpus, tmp_path, over):
    """fit(6) with checkpoint_every=2 (steps 2, 4, 6 written, keep_n=2
    kept) is bitwise fit(3), save, a fresh engine's fit(3): topics, D, W
    and the LLPT; export() freezes the same W. The warp engine builds its
    alias tables once per chunk of iterations, as the reference's does,
    so its run is bitwise only where both runs chunk alike: with
    ``eval_every=1`` every chunk is one iteration."""
    cfg = LDAConfig(**{"fused": True, **KW, **over})
    mgr = _Recording(str(tmp_path / "a"), keep_n=2)
    a = LDAEngine(port_corpus(corpus), cfg, device="cpu",
                  checkpoint_manager=mgr)
    ha = a.fit(6, checkpoint_every=2)
    assert mgr.saved == [2, 4, 6] and mgr.all_steps() == [4, 6]
    b = LDAEngine(port_corpus(corpus), cfg, device="cpu",
                  checkpoint_dir=str(tmp_path / "b"))
    b.fit(3)
    b.save()
    c = LDAEngine(port_corpus(corpus), cfg, device="cpu",
                  checkpoint_dir=str(tmp_path / "b"))
    hc = c.fit(3)                        # the first fit restores step 3
    assert c.iteration == a.iteration == 6
    n = a.corpus.n_tokens
    assert torch.equal(c.state.topics[:n], a.state.topics[:n])
    assert torch.equal(c.state.D, a.state.D)
    assert torch.equal(c.state.W, a.state.W)
    assert hc["llpt"][-1] == ha["llpt"][ha["iteration"].index(
        hc["iteration"][-1])]
    assert c.score() == a.score()
    # every configuration leaves a dense state behind, so export() works
    assert np.array_equal(c.export().W, a.state.W.numpy())
    assert 0 < a.state_nbytes()
    # the step-6 checkpoint of the first run holds the same state
    d = LDAEngine(port_corpus(corpus), cfg, device="cpu",
                  checkpoint_manager=CheckpointManager(str(tmp_path / "a")))
    assert np.array_equal(d.resume().host_payload()["topics_global"],
                          a.host_payload()["topics_global"])


# ---------------------------------------------------------------------------
# the restore path's repairs
# ---------------------------------------------------------------------------

def test_legacy_padded_payload_restores(corpus):
    """The reference trainer's own payload (padded ``topics``) restores in
    the port engine, as it does in the reference's."""
    jeng = JaxEngine(corpus, JaxConfig(fused=True, **KW), backend="single")
    jeng.fit(3)
    legacy = jeng.trainer.host_payload(jeng.state)
    assert "topics" in legacy and "topics_global" not in legacy
    assert legacy["topics"].shape[0] > jeng.corpus.n_tokens     # padded
    teng = LDAEngine(port_corpus(corpus), LDAConfig(fused=True, **KW),
                     device="cpu").restore(legacy)
    assert teng.iteration == 3
    assert np.array_equal(teng.host_payload()["topics_global"],
                          jeng.host_payload()["topics_global"])
    assert np.array_equal(teng.state.W.numpy(), np.asarray(jeng.state.W))


def _mid_epoch_payload(corpus):
    """A real mid-epoch payload of the reference's streamed trainer."""
    from repro.lda.trainer import LDATrainer as JaxTrainer
    cfg = JaxConfig(n_topics=KW["n_topics"], tile_size=KW["tile_size"],
                    corpus_residency="streamed", stream_shards=4)
    from repro.lda.corpus import relabel_by_frequency
    tr = JaxTrainer(relabel_by_frequency(corpus)[0], cfg, _from_engine=True)
    pipe = tr.fused_pipeline()
    ss = pipe.run_shards(pipe.from_lda_state(tr.init_state()), 2)
    assert ss.cursor == 2
    return pipe.stream_payload(ss)


def test_mid_epoch_streamed_payload_is_rejected(corpus, tmp_path):
    """Its topics_global is rewound to the epoch start: restore, resume,
    the trainer's state_from_payload and from_payload all refuse it."""
    payload = _mid_epoch_payload(corpus)
    cfg = LDAConfig(fused=True, **KW)
    eng = LDAEngine(port_corpus(corpus), cfg, device="cpu",
                    checkpoint_dir=str(tmp_path))
    restore_streamed = "mid-epoch.*corpus_residency='streamed'"
    with pytest.raises(ValueError, match=restore_streamed):
        eng.restore(payload)
    with pytest.raises(ValueError, match=restore_streamed):
        LDATrainer(eng.corpus, cfg, device="cpu").state_from_payload(payload)
    JaxManager(str(tmp_path)).save(1, payload)
    with pytest.raises(ValueError, match=restore_streamed):
        eng.resume()
    with pytest.raises(ValueError, match=restore_streamed):
        eng.fit(1)                   # the first fit restores it too
    with pytest.raises(ValueError, match="MID-EPOCH"):
        FrozenLDAModel.from_payload(payload, eng.corpus, cfg, device="cpu")


def test_malformed_payload_actionable_errors(corpus):
    eng = LDAEngine(port_corpus(corpus), LDAConfig(fused=True, **KW),
                    device="cpu")
    key = key_data(0)
    with pytest.raises(ValueError, match="different corpus"):
        eng.restore({"topics_global": np.zeros(3, np.int32), "key": key,
                     "iteration": 1})
    with pytest.raises(ValueError, match="topics"):
        eng.restore({"key": key, "iteration": 1})
    with pytest.raises(ValueError, match="different corpus or tiling"):
        eng.restore({"topics": np.zeros(7, np.int32), "key": key,
                     "iteration": 0})
    n = eng.corpus.n_tokens
    with pytest.raises(ValueError, match="outside"):
        eng.restore({"topics_global": np.full(n, 16, np.int32),
                     "key": key, "iteration": 0})


def test_engine_checkpoint_surface(corpus, tmp_path):
    """save/resume need a manager; checkpoint_dir and checkpoint_manager
    exclude each other; resume without a checkpoint is a fresh init; the
    serving surface publishes the live W to its subscribers."""
    cfg = LDAConfig(fused=True, **KW)
    eng = LDAEngine(port_corpus(corpus), cfg, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        eng.resume()
    eng.fit(1)
    with pytest.raises(ValueError, match="checkpoint"):
        eng.save()
    with pytest.raises(ValueError, match="not both"):
        LDAEngine(port_corpus(corpus), cfg, device="cpu",
                  checkpoint_dir=str(tmp_path),
                  checkpoint_manager=CheckpointManager(str(tmp_path)))
    fresh = LDAEngine(port_corpus(corpus), cfg, device="cpu",
                      checkpoint_dir=str(tmp_path)).resume()
    assert fresh.iteration == 0
    # supervision needs a checkpoint manager, as in the reference
    with pytest.raises(ValueError, match="checkpoint"):
        eng.fit(1, supervise=True)
    # the serving surface (#13): a snapshot of the live state to each
    # subscriber, none after unsubscribing
    seen = []
    unsubscribe = eng.subscribe(seen.append)
    snap = eng.publish_serving()
    assert seen == [snap] and snap.cursor == 0
    assert np.array_equal(snap.W, eng.export().W)
    unsubscribe()
    eng.publish_serving()
    assert seen == [snap]
    assert eng.state_nbytes() == eng.state.nbytes()


def test_launcher_trains_checkpoints_and_exports(tmp_path, monkeypatch,
                                                 capsys):
    """``train_lda``, the ``--lda`` mode: trains, saves at the checkpoint
    boundaries, exports a model the reference loads, resumes from its
    checkpoints on a second call; runs on the card unless asked for the
    CPU. ``main`` hands its flags to ``train_lda``; without ``--lda`` it
    hands the LM flags to ``train_lm``."""
    from repro.lda.api import FrozenLDAModel as JaxModel
    from repro_torch.launch import train as launch
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "m.npz")
    kw = dict(n_topics=8, n_docs=60, n_words=80, checkpoint_dir=ckpt,
              checkpoint_every=3, export_path=out, device="cpu")
    hist = launch.train_lda(iters=6, **kw)
    assert hist["llpt"][-1] >= hist["llpt"][0]
    assert CheckpointManager(ckpt).all_steps() == [3, 6]
    assert JaxModel.load(out).W.shape == (80, 8)
    launch.train_lda(iters=2, **kw)
    assert CheckpointManager(ckpt).all_steps() == [3, 6]
    assert "iter=   7" in capsys.readouterr().out    # resumed at 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.train_lda(n_topics=8, iters=1, n_docs=20, n_words=30)

    calls, llpt = [], [-9.0, -8.0]
    monkeypatch.setattr(launch, "train_lda",
                        lambda **kw: calls.append(kw) or {"llpt": llpt})
    argv = ["--lda", "--lda-topics", "8", "--lda-docs", "60",
            "--lda-words", "80", "--lda-iters", "6", "--lda-backend",
            "single", "--checkpoint-dir", ckpt, "--checkpoint-every", "3",
            "--lda-export", out]
    assert launch.main(argv) == 0
    assert calls[-1] == dict(n_topics=8, iters=6, n_docs=60, n_words=80,
                             fmt="dense", backend="single", balance="none",
                             mesh_shape=(), checkpoint_dir=ckpt,
                             checkpoint_every=3, export_path=out,
                             device=None, log_fn=print)
    llpt.reverse()
    assert launch.main(argv) == 1                    # LLPT fell
    lm_calls = []
    monkeypatch.setattr(launch, "train_lm", lambda arch, **kw: lm_calls.append(
        (arch, kw)) or {"loss": [1.0]})
    assert launch.main([]) == 0                      # LM mode, the defaults
    assert lm_calls[-1] == ("qwen1.5-0.5b", dict(
        steps=200, seq_len=256, global_batch=8, reduced=True,
        checkpoint_dir=None, lr=3e-3, device=None))
    with pytest.raises(SystemExit, match="torchrun"):   # not under torchrun
        launch.main(["--lda", "--lda-backend", "distributed"])


def test_host_payload_takes_no_deprecated_array_path(corpus):
    """``host_payload`` copies the topics through ``Tensor.numpy``: no
    ``np.array(tensor)`` call, which NumPy 2 warns about (``copy=``
    passed to an ``__array__`` that does not take it)."""
    import warnings
    from repro_torch.lda.model import LDAState, SparseLDAState
    eng = LDAEngine(port_corpus(corpus), LDAConfig(fused=True, **KW),
                    device="cpu")
    eng.fit(1)
    st = eng.state
    sparse = SparseLDAState(st.topics, st.D, st.W, (), st.W.sum(0),
                            torch.zeros((), dtype=torch.int32), 1)
    for state in (st, sparse):
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            payload = state.host_payload()
        assert np.array_equal(payload["topics"], st.topics.numpy())
        assert payload["topics"].base is None or \
            not np.shares_memory(payload["topics"], st.topics.numpy())
