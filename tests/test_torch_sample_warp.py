"""The warp kernels' wrappers (on the CPU: their plain twins) against the
reference: ``vose_build`` against ``mh.run_vose``, and the port's
``sample_warp_tiled`` against the Pallas kernel in interpret mode, with
the full vocabulary as the window and with a narrow window.

Tolerance: bitwise, for topics, accepted counts, prob and alias. The
inputs make q identical in both packages: W̃ rows hold integer values,
whose row sums are exact in any order (``tests/test_torch_mh.py`` counts
the rows whose q differs on real-valued weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mh as jmh
from repro.kernels.sample_warp import sample_warp_tiled as pallas_warp
from repro_torch.core import mh
from repro_torch.kernels import sample_warp as sw

T = torch.from_numpy


def _case(seed, *, V, K, M=24, n=300, C=2, near_one=False):
    rng = np.random.default_rng(seed)
    w_til = rng.integers(0, 30, (V, K)).astype(np.float32)
    w_til[rng.random((V, K)) < 0.5] = 0.0
    w_til += 1.0                                   # integers: exact sums
    w_hat = (w_til + rng.integers(0, 3, (V, K))) / 128.0   # live, moved on
    D = rng.integers(0, 20, (M, K)).astype(np.int32)
    word = np.sort(rng.integers(0, V, n)).astype(np.int32)
    doc = rng.integers(0, M, n).astype(np.int32)
    u = rng.random((C, 4, n)).astype(np.float32)
    if near_one:                           # ⌊u·K⌋ may round up to K
        u = np.minimum(1 - u * 2.0**-16, np.float32(1 - 2.0**-24)).astype(
            np.float32)
    q = w_til / w_til.sum(axis=1, keepdims=True)
    scaled = (q * K).astype(np.float32)
    return dict(w_til=w_til, w_hat=w_hat.astype(np.float32), D=D, word=word,
                doc=doc, s0=rng.integers(0, K, n).astype(np.int32),
                t_doc=rng.integers(0, K, (C, n)).astype(np.int32),
                u_draw=np.ascontiguousarray(u[:, :2]),
                u_acc=np.ascontiguousarray(u[:, 2:]),
                scaled=scaled, C=C, K=K, V=V)


@pytest.mark.parametrize("V,K", [(40, 12), (17, 1), (33, 37)])
def test_vose_build_twin_bitwise_vs_reference(V, K):
    x = _case(V + K, V=V, K=K)
    jq = jmh.alias_queues(jnp.asarray(x["scaled"]))
    jp, ja = jmh.run_vose(jnp.asarray(x["scaled"]), *jq, onehot=True)
    before = sw.vose_build.launches
    tp, ta = sw.vose_build(T(x["scaled"]),
                           *(T(np.array(a)) for a in jq))
    assert sw.vose_build.launches == before      # the CPU takes the twin
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    tables = sw.alias_tables(T(x["w_til"]))
    ref = mh.build_alias_tables(T(x["w_til"]))
    for a, b in zip(tables, ref):
        assert torch.equal(a, b)


def _both(x, *, first, win, alpha=0.25):
    """(Pallas, port) of sample_warp_tiled on the same inputs."""
    jq = jmh.alias_queues(jnp.asarray(x["scaled"]))
    d_rows = x["D"][x["doc"]]
    j_s, j_acc = pallas_warp(
        jnp.asarray(x["s0"]), jnp.asarray(d_rows), jnp.asarray(x["t_doc"]),
        jnp.asarray(x["u_draw"]), jnp.asarray(x["u_acc"]),
        jnp.asarray(x["w_hat"]), jnp.asarray(x["w_til"]), *jq,
        jnp.asarray(x["word"]), jnp.int32(first), alpha=alpha,
        n_cycles=x["C"], win_words=win, tile_t=128, interpret=True)
    t_s, t_acc = sw.sample_warp_tiled(
        T(x["s0"]), T(d_rows), T(x["t_doc"]), T(x["u_draw"]), T(x["u_acc"]),
        T(x["w_hat"]), T(x["w_til"]), *(T(np.array(a)) for a in jq),
        T(x["word"]), first, alpha=alpha, win_words=win)
    return (np.asarray(j_s), np.asarray(j_acc)), (t_s.numpy(), t_acc.numpy())


@pytest.mark.parametrize("near_one", [False, True])
@pytest.mark.parametrize("window", ["full", "narrow"])
def test_sample_warp_tiled_bitwise_vs_pallas(window, near_one):
    x = _case(3, V=48, K=16, near_one=near_one)
    if window == "full":
        first, win = 0, x["V"]
    else:          # a narrow window: tokens outside it read clipped rows
        first, win = int(x["word"][100]), 8
    (j_s, j_acc), (t_s, t_acc) = _both(x, first=first, win=win)
    assert np.array_equal(j_s, t_s)
    assert np.array_equal(j_acc, t_acc)
    assert 0 < (t_acc > 0).mean() <= 1
    assert t_s.min() >= 0 and t_s.max() < x["K"]


def test_chain_tiled_equals_untiled_where_tiles_fit():
    """The tiled chain reads each token's rows through its tile's window:
    bitwise the untiled chain for tiles whose word run fits."""
    x = _case(5, V=200, K=24, n=512)
    tables = mh.build_alias_tables(T(x["w_til"]))
    args = (T(x["t_doc"]), T(x["u_draw"]), T(x["u_acc"]), T(x["D"]),
            T(x["w_hat"]), tables)
    ids = (T(x["s0"]), T(x["doc"]), T(x["word"]))
    size = 64
    first = T(x["word"][::size].copy())
    span = max(int(x["word"][min(i + size, 512) - 1] - x["word"][i]) + 1
               for i in range(0, 512, size))
    win = 1 << (span - 1).bit_length()
    a = sw.warp_chain_tiled_rows(*ids, first, size, *args, win_words=win,
                                 alpha=0.25)
    b = sw.warp_chain_rows(*ids, *args, alpha=0.25)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    # a window narrower than the runs reads other rows: the routes differ
    c = sw.warp_chain_tiled_rows(*ids, first, size, *args, win_words=1,
                                 alpha=0.25)
    assert not torch.equal(c[0], b[0])


def test_chain_wrappers_reject_what_the_kernel_cannot_take():
    x = _case(7, V=20, K=8, n=64)
    tables = mh.build_alias_tables(T(x["w_til"]))
    ids = (T(x["s0"]), T(x["doc"]), T(x["word"]))
    args = [T(x["t_doc"]), T(x["u_draw"]), T(x["u_acc"]), T(x["D"]),
            T(x["w_hat"]), tables]
    with pytest.raises(ValueError, match="t_doc"):
        sw.warp_chain_rows(*ids, args[0][:, :10], *args[1:], alpha=0.1)
    bad = T(x["t_doc"]).clone()
    bad[0, 3] = 8
    with pytest.raises(ValueError, match="topic"):
        sw.warp_chain_rows(*ids, bad, *args[1:], alpha=0.1)
    with pytest.raises(ValueError, match="word"):
        sw.warp_chain_rows(ids[0], ids[1], ids[2] + 20, *args, alpha=0.1)
    with pytest.raises(ValueError, match="scaled"):
        sw.vose_build(T(x["scaled"]).double(), tables.alias, tables.alias,
                      torch.zeros(20, dtype=torch.int32))
