"""repro_torch foundations against the reference: corpus arrays, config
validation, the device rule, and the import boundary.

The corpus layer is NumPy in both packages, so every array must be equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.lda import corpus as jc
from repro.lda.model import LDAConfig as JaxConfig
from repro_torch.lda import corpus as tc
from repro_torch.lda.model import LDAConfig, uniforms_generator
from repro_torch.runtime.device import resolve_device

REPO = Path(__file__).resolve().parents[1]


def _assert_same_corpus(a, b):
    for f in dataclasses.fields(jc.Corpus):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_and_relabel_match_reference(seed):
    kw = dict(n_docs=40, n_words=70, n_topics=6, mean_doc_len=30)
    a = jc.synthetic_lda_corpus(seed, **kw)
    b = tc.synthetic_lda_corpus(seed, **kw)
    _assert_same_corpus(a, b)
    (ra, ma), (rb, mb) = jc.relabel_by_frequency(a), tc.relabel_by_frequency(b)
    _assert_same_corpus(ra, rb)
    assert np.array_equal(ma, mb)
    assert [x.tolist() for x in ra.documents()] == \
        [x.tolist() for x in rb.documents()]


def test_zipf_from_documents_and_pad_match_reference():
    a = jc.zipf_corpus(1, n_docs=30, n_words=50, exponent=1.3)
    b = tc.zipf_corpus(1, n_docs=30, n_words=50, exponent=1.3)
    _assert_same_corpus(a, b)
    docs = [[3, 1, 1], [], [0, 4]]
    _assert_same_corpus(jc.from_documents(docs, 5), tc.from_documents(docs, 5))
    for multiple in (1, 64, 1000):
        (pa, ka), (pb, kb) = jc.pad_corpus(a, multiple), tc.pad_corpus(b, multiple)
        _assert_same_corpus(pa, pb)
        assert np.array_equal(ka, kb)
    padded, mask = tc.pad_corpus(b, 1000)
    # pads take the LAST word id (T stays sorted) and doc 0, with mask 0
    assert np.all(padded.word_ids[b.n_tokens:] == b.word_ids[-1])
    assert np.all(padded.doc_ids[b.n_tokens:] == 0)
    assert mask.sum() == b.n_tokens


def test_validate_rejects_broken_index():
    c = tc.zipf_corpus(2, n_docs=10, n_words=20)
    c.validate()
    broken = dataclasses.replace(c, inv_token_idx=np.zeros_like(c.inv_token_idx))
    with pytest.raises(ValueError, match="permutation"):
        broken.validate()


def test_planted_corpus_is_sorted_and_relabeled():
    c = tc.planted_corpus(5, n_docs=200, n_words=300, n_tokens=20_000,
                          n_planted=20, words_per_topic=30)
    c.validate()
    assert abs(c.n_tokens - 20_000) < 1_000
    counts = c.word_token_counts
    assert np.all(np.diff(counts) <= 0)          # the engine skips relabel
    again = tc.planted_corpus(5, n_docs=200, n_words=300, n_tokens=20_000,
                              n_planted=20, words_per_topic=30)
    _assert_same_corpus(c, again)                # a function of the seed


@pytest.mark.parametrize("high", [7, 1 << 16, 300_000, (1 << 32) - 1])
def test_stable_argsort_is_numpys(high):
    """The corpus build's 16-bit radix passes give NumPy's stable argsort,
    ties in order, for keys above and below 2**16."""
    keys = np.random.default_rng(high % 97).integers(0, high, 50_000,
                                                     dtype=np.int64)
    keys[::7] = keys[0]                           # long runs of ties
    got = tc._stable_argsort(keys)
    assert np.array_equal(got, np.argsort(keys, kind="stable"))


def test_config_validation_mirrors_reference():
    cfg = LDAConfig(n_topics=8)
    ref = JaxConfig(n_topics=8)
    assert cfg.alpha_ == ref.alpha_ and cfg.impl == "kernel"
    for bad in (dict(n_topics=0), dict(n_topics=8, g=0),
                dict(n_topics=8, impl="pallas"), dict(n_topics=8, beta=0),
                dict(n_topics=8, alpha=-1.0), dict(n_topics=8, eval_every=0),
                dict(n_topics=8, survivor_capacity=0)):
        with pytest.raises(ValueError):
            LDAConfig(**bad)
    # the reference crashes inside top_k for K < g+1; the port says why
    with pytest.raises(ValueError, match="g\\+1"):
        LDAConfig(n_topics=2, g=2)
    LDAConfig(n_topics=3, g=2)


@pytest.mark.parametrize("knob,ported", [
    (dict(sampler="two_branch"), "sampler"), (dict(selfcheck=True), True),
    (dict(dist=object()), "dist")])
def test_unported_knobs_raise_not_implemented(knob, ported):
    # every knob that once raised NotImplementedError is ported now
    if ported == "dist":            # dist arrived with multi-GPU: a value
        # that is not a DistConfig is the reference's ValueError
        with pytest.raises(ValueError, match="must be a DistConfig"):
            LDAConfig(n_topics=8, **knob)
        return
    if ported == "sampler":         # the two-branch sampler: the config
        # builds; the engine refuses the paths it cannot run
        assert LDAConfig(n_topics=8, **knob).sampler == "two_branch"
        return
    assert LDAConfig(n_topics=8, **knob).selfcheck  # the failure model


@pytest.mark.parametrize("knob,match", [
    # the reference's test_config_rejects_bad_streaming_knobs
    (dict(corpus_residency="paged"), "corpus_residency"),
    (dict(stream_shards=1), "stream_shards"),
    (dict(device_budget_bytes=0), "device_budget_bytes"),
    # its test_disk_config_validation
    (dict(corpus_residency="disk"), "corpus_path"),
    (dict(corpus_path="/somewhere"), "corpus_path"),
    (dict(corpus_residency="disk", corpus_path="/somewhere",
          stream_shards=4), "stream_shards"),
    (dict(stream_watchdog_seconds=0.0), "stream_watchdog_seconds"),
    # and the settings both accept
    (dict(corpus_residency="streamed", stream_shards=2), None),
    (dict(corpus_residency="auto", device_budget_bytes=1 << 30), None),
    (dict(corpus_residency="disk", corpus_path="/somewhere"), None),
    (dict(corpus_residency="auto", corpus_path="/somewhere"), None),
    (dict(corpus_residency="streamed", stream_watchdog_seconds=2.5), None)])
def test_streaming_knobs_validate_as_the_reference(knob, match):
    if match is None:
        cfg, ref = LDAConfig(n_topics=8, **knob), JaxConfig(n_topics=8,
                                                             **knob)
        for name in knob:
            assert getattr(cfg, name) == getattr(ref, name)
        return
    with pytest.raises(ValueError, match=match):
        JaxConfig(n_topics=8, **knob)
    with pytest.raises(ValueError, match=match):
        LDAConfig(n_topics=8, **knob)


def test_hybrid_and_tile_knobs_are_ported():
    cfg = LDAConfig(n_topics=8, format="hybrid", tail_sampler="sparse",
                    balance="tiles", d_capacity=5, dense_word_threshold=3)
    ref = JaxConfig(n_topics=8, format="hybrid", dense_word_threshold=3)
    assert cfg.dense_threshold_ == ref.dense_threshold_ == 3
    assert LDAConfig(n_topics=8).dense_threshold_ == 8


def test_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_engine_without_card_raises(monkeypatch):
    from repro_torch.lda import LDAEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = tc.zipf_corpus(0, n_docs=10, n_words=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LDAEngine(c, LDAConfig(n_topics=4))
    # the reference's test_supervise_needs_manager
    with pytest.raises(ValueError, match="checkpoint"):
        LDAEngine(c, LDAConfig(n_topics=4), "cpu").fit(1, supervise=True)
    assert LDAEngine(c, LDAConfig(n_topics=4), "cpu").device.type == "cpu"


def test_generator_streams_are_deterministic_and_distinct():
    cpu = torch.device("cpu")
    a = torch.rand(64, generator=uniforms_generator(0, 3, cpu))
    b = torch.rand(64, generator=uniforms_generator(0, 3, cpu))
    c = torch.rand(64, generator=uniforms_generator(0, 4, cpu))
    d = torch.rand(64, generator=uniforms_generator(1, 3, cpu))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_port_imports_neither_jax_nor_repro():
    """Importing every port module (and chip_smoke.py) loads no JAX and no
    module of the reference package."""
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        f"runpy.run_path({str(REPO / 'chip_smoke.py')!r}, run_name='chip')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for m in ("kernels.sample_fused", "kernels.sample_sparse",
              "kernels.nvcc", "core.sparse", "core.balance",
              "checkpoint.manager", "lda.api", "launch.train",
              "models.transformer", "models.ssm", "models.moe",
              "models.encdec", "train.train_step", "train.serve_step",
              "data.synthetic", "roofline.analysis", "roofline.flops_model",
              "launch.dryrun"):
        assert f"repro_torch.{m}" in modules
