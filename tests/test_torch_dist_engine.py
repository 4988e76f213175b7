"""The distributed engine in gloo worlds of 2 and 4 processes, on the CPU.

One world of 4 and one of 2 run every scenario once
(``tests/_torch_dist.py``: the reference's ``tests/test_distributed.py``
corpus, K = 16); the tests read their results. The port's single-device
engine runs the same configurations in this process.

* Model axis 1 — (4,1) and (2,1) dense, (4,1) ``balance="tiles"`` with
  shared rows, (2,1) hybrid, a (2,2,1) pod mesh — is bitwise the
  single-device run: topics, D, W and every LLPT. Every rank gathers the
  same counts.
* The (2,2) topic split: D and W equal the histograms of its topics, its
  LLPT within 0.15 of the single run's after 15 iterations (the
  reference's own model-axis bound, ``tests/test_distributed.py``), and
  its sweep in chunks of 1,024 tokens bitwise its sweep in one.
* Checkpoints: an elastic restore of a (4,1) checkpoint on (2,1) gives
  the same global counts; a distributed payload restores in the port's
  and the reference's single engines with D and W bitwise
  ``gather_global``'s; a reference single-engine payload restores in the
  distributed engine with the reference's D and W.
* ``backend="auto"`` picks distributed in a world of 2; every refusal
  carries its message; the launcher trains under ``torchrun`` on the CPU.

Branch statistics are masked means over the real tokens (the
reference's), the single path's means over its padded slots: they agree
to within the pad fraction.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from repro.lda.api import LDAEngine as JaxEngine
from repro.lda.corpus import (relabel_by_frequency as jrelabel,
                              synthetic_lda_corpus)
from repro.lda.model import LDAConfig as JaxConfig
from repro_torch.lda.api import LDAEngine
import _torch_dist as td
from _torch_parity import port_corpus

REF_ITERS = 3


@pytest.fixture(scope="module")
def ref_corpus():
    c = synthetic_lda_corpus(0, n_docs=80, n_words=100, n_topics=8,
                             mean_doc_len=50)
    return jrelabel(c)[0]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, ref_corpus):
    tmp = tmp_path_factory.mktemp("worlds")
    # a reference single-engine checkpoint payload, for the world of 2
    jeng = JaxEngine(ref_corpus, JaxConfig(n_topics=16, tile_size=512,
                                           fused=True), backend="single")
    jeng.fit(REF_ITERS)
    ref = {k: np.asarray(v) for k, v in jeng.host_payload().items()}
    np.savez(tmp / "ref.npz", **ref)
    r4 = td.run_world(4, "world4", (str(tmp / "elastic"),), tmp)
    r2 = td.run_world(2, "world2", (str(tmp / "elastic"),
                                    str(tmp / "ref.npz"), str(tmp / "ckpt")),
                      tmp)
    return {"4": r4, "2": r2, "ref_D": np.asarray(jeng.state.D),
            "ref_W": np.asarray(jeng.state.W), "ckpt": tmp / "ckpt"}


@pytest.fixture(scope="module")
def singles(worlds):
    corpus, out = td.make_corpus(), {}
    for name, _shape, _axes, kw, iters, every in td.WORLD4 + td.WORLD2:
        kw = {k: v for k, v in kw.items() if k != "sweep_tokens"}
        eng = LDAEngine(corpus, td.make_config(eval_every=every, **kw),
                        device="cpu", backend="single")
        out[name] = td.summary(eng, eng.fit(iters))
    return out


def _result(worlds, name):
    world = "4" if name in {c[0] for c in td.WORLD4} else "2"
    return worlds[world], worlds[world][0][name]


def test_workers_build_the_reference_corpus(ref_corpus):
    got, want = td.make_corpus(), port_corpus(ref_corpus)
    for f in ("word_ids", "doc_ids", "doc_lengths", "word_token_counts"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


BITWISE = ["dense_4x1", "tiles_4x1", "pod_2x2x1", "dense_2x1", "hybrid_2x1"]


@pytest.mark.parametrize("name", BITWISE)
def test_model_axis_1_is_bitwise_single(worlds, singles, name):
    ranks, got = _result(worlds, name)
    want = singles[name]
    for key in ("topics", "D", "W"):
        assert np.array_equal(got[key], want[key]), key
    assert got["llpt"] == want["llpt"] and len(got["llpt"]) >= 2
    assert got["iterations"] == want["iterations"]
    assert got["score"] == want["llpt"][-1]
    for r in ranks:                       # every rank gathers the same
        for key in ("topics", "D", "W"):
            assert np.array_equal(r[name][key], got[key]), key


@pytest.mark.parametrize("name", BITWISE + ["dense_2x2"])
def test_stats_within_the_pad_fraction_of_single(worlds, singles, name):
    ranks, got = _result(worlds, name)
    n_real = got["topics"].shape[0]
    pad = (-n_real) % td.BASE["tile_size"]
    bound = pad / (n_real + pad) + 1e-6
    for a, b in zip(got["stats"], singles[name]["stats"]):
        for key in ("frac_skipped", "frac_m_final", "frac_unchanged",
                    "frac_at_max"):
            assert 0.0 <= a[key] <= 1.0
            if name != "dense_2x2":
                assert abs(a[key] - b[key]) <= bound, (key, a, b)
    assert all(r[name]["stats"] == got["stats"] for r in ranks)


def test_tiles_replicate_dissected_rows(worlds):
    ranks, got = _result(worlds, "tiles_4x1")
    assert got["n_shared"] > 0
    assert [r["tiles_4x1"]["shard"] for r in ranks] == [0, 1, 2, 3]
    assert got["D"].sum() == got["topics"].shape[0]


def test_pod_mesh_layout(worlds):
    ranks, got = _result(worlds, "pod_2x2x1")
    assert got["mesh"] == {"pod": 2, "data": 2, "model": 1}
    assert [r["pod_2x2x1"]["shard"] for r in ranks] == [0, 1, 2, 3]
    assert [r["pod_2x2x1"]["coords"]["pod"] for r in ranks] == [0, 0, 1, 1]


def _histograms(topics, K=16):
    c = td.make_corpus()
    D = np.zeros((c.n_docs, K), np.int64)
    W = np.zeros((c.n_words, K), np.int64)
    np.add.at(D, (c.doc_ids, topics), 1)
    np.add.at(W, (c.word_ids, topics), 1)
    return D, W


def test_topic_split_counts_exact_and_llpt_close(worlds, singles):
    ranks, got = _result(worlds, "dense_2x2")
    D, W = _histograms(got["topics"])
    assert np.array_equal(got["D"], D) and np.array_equal(got["W"], W)
    assert got["iteration"] == 15
    assert abs(got["llpt"][-1] - singles["dense_2x2"]["llpt"][-1]) < 0.15
    assert got["llpt"][-1] > got["llpt"][0]
    assert [r["dense_2x2"]["coords"] for r in ranks] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]


def test_topic_split_chunking_changes_no_bit(worlds):
    _, a = _result(worlds, "dense_2x2")
    _, b = _result(worlds, "dense_2x2_chunked")
    for key in ("topics", "D", "W"):
        assert np.array_equal(a[key], b[key]), key
    assert a["llpt"] == b["llpt"]


def test_elastic_restore_from_4_to_2(worlds):
    saved = worlds["4"][0]["elastic_saved"]
    for r in worlds["2"]:
        got = r["elastic_restored"]
        assert got["iteration"] == saved["iteration"] == td.ELASTIC_ITERS
        for key in ("topics", "D", "W"):
            assert np.array_equal(got[key], saved[key]), key
        assert got["mesh"] == {"data": 2, "model": 1}


def test_auto_picks_distributed_in_a_world_of_2(worlds):
    for r in worlds["2"]:
        assert r["auto"] == {"backend": "distributed",
                             "mesh": {"data": 2, "model": 1}}


def test_distributed_payload_restores_in_both_single_engines(worlds,
                                                             ref_corpus):
    saved = worlds["2"][0]["saved"]
    path = worlds["2"][0]["saved_path"]
    assert os.path.basename(path) == "step_00000003.npz"
    assert sorted(os.listdir(worlds["ckpt"])) == ["step_00000003.npz"]
    port = LDAEngine(td.make_corpus(), td.make_config(), device="cpu",
                     backend="single", checkpoint_dir=str(worlds["ckpt"]))
    port.resume()
    assert port.iteration == 3
    assert np.array_equal(port.state.D.numpy(), saved["D"])
    assert np.array_equal(port.state.W.numpy(), saved["W"])
    assert np.array_equal(port.host_payload()["topics_global"],
                          saved["topics"])
    jeng = JaxEngine(ref_corpus, JaxConfig(n_topics=16, tile_size=512,
                                           fused=True), backend="single",
                     checkpoint_dir=str(worlds["ckpt"]))
    jeng.resume()
    assert jeng.iteration == 3
    assert np.array_equal(np.asarray(jeng.state.D), saved["D"])
    assert np.array_equal(np.asarray(jeng.state.W), saved["W"])


def test_reference_payload_restores_in_distributed_engine(worlds):
    for r in worlds["2"]:
        got = r["ref_restored"]
        assert got["iteration"] == REF_ITERS
        assert np.array_equal(got["D"], worlds["ref_D"])
        assert np.array_equal(got["W"], worlds["ref_W"])


@pytest.mark.parametrize("name,kind,match", [
    ("warp", "ValueError", "sampler='warp' is single-backend only"),
    ("hybrid_model_axis", "ValueError",
     "format='hybrid' needs a model mesh axis of size 1"),
    ("hybrid_tiles", "ValueError",
     "balance='tiles' with format='hybrid' is not supported"),
    ("k_not_divisible", "ValueError",
     "n_topics=15 is not divisible by the model mesh axis (2)"),
    ("w_sync_ps", "NotImplementedError",
     "#12 (second part: parameter server)"),
    ("streamed", "NotImplementedError", "#12 (second part"),
    ("disk", "ValueError",
     "corpus_residency='disk' needs the single backend"),
    ("supervise", "NotImplementedError", "#12 (second"),
    ("mesh_and_mesh_shape", "ValueError",
     "pass mesh= OR DistConfig.mesh_shape"),
    ("mesh_product", "ValueError", "default process group has world size 2"),
    ("no_model_axis", "ValueError", "lack a 'model' axis"),
    ("direct_construction", "TypeError", "engine-internal backend")])
def test_rejections(worlds, name, kind, match):
    for r in worlds["2"]:
        got_kind, msg = r["rejections"][name]
        assert got_kind == kind and match in msg, (got_kind, msg)


def test_launcher_under_torchrun(tmp_path):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--lda", "--lda-backend", "distributed", "--lda-mesh", "2,1",
           "--device", "cpu", "--lda-topics", "8", "--lda-docs", "60",
           "--lda-words", "80", "--lda-iters", "4",
           "--checkpoint-dir", str(tmp_path / "ckpt"),
           "--checkpoint-every", "2", "--lda-export",
           str(tmp_path / "model.npz")]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "backend=distributed" in proc.stdout
    assert proc.stdout.count("serving artifact written") == 1    # rank 0
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000002.npz", "step_00000004.npz"]
    with np.load(tmp_path / "model.npz") as z:
        assert z["W"].shape == (80, 8) and z["W"].sum() > 0
