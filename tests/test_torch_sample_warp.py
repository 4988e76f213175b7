"""The warp kernels' wrappers (on the CPU: their plain twins) against the
reference: ``vose_build`` against ``mh.run_vose``, the port's
``sample_warp_tiled`` against the Pallas kernel in interpret mode, with
the full vocabulary as the window and with a narrow window, and the main
path's chain (``warp_chain_tokens``, doc proposals drawn inside) against
the reference's ``doc_proposals`` followed by the Pallas kernel.

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


def _stream(seed, *, V=40, K=16, M=30, N=700, C=2, near_one=False,
            one_real=False):
    """Whole-corpus streams as the pipeline holds them: word-sorted tokens
    with padding, docs of one token and an empty doc, the iteration's
    uniforms, and integer-valued W̃ (the same q in both packages)."""
    rng = np.random.default_rng(seed)
    word = np.sort(rng.integers(0, V, N)).astype(np.int32)
    doc = rng.integers(0, M - 3, N).astype(np.int32)
    lone = N // 2 + 1
    doc[[5, lone]] = M - 3, M - 2           # two docs of one token each
    mask = np.ones(N, np.int32)             # doc M − 1 has no token
    mask[::11] = 0
    if one_real:                            # the doc index's perm: 1 slot
        mask[:] = 0
        mask[lone] = 1
    u = [rng.random((C, m, N)).astype(np.float32) for m in (3, 2, 2)]
    if near_one:                 # ⌊u·K⌋ and ⌊u·L⌋ may round up to K, L
        u[:2] = [np.minimum(1 - a * 2.0**-16, np.float32(1 - 2.0**-24))
                 .astype(np.float32) for a in u[:2]]
    w_til = rng.integers(0, 30, (V, K)).astype(np.float32)
    w_til[rng.random((V, K)) < 0.5] = 0.0
    w_til += 1.0
    return dict(word=word, doc=doc, mask=mask, u=u, w_til=w_til,
                w_hat=((w_til + rng.integers(0, 3, (V, K))) / 128.0).astype(
                    np.float32),
                D=rng.integers(0, 20, (M, K)).astype(np.int32),
                topics=rng.integers(0, K, N).astype(np.int32), C=C, K=K, V=V,
                M=M, N=N)


def _pallas_chain(x, idx, first, win, alpha):
    """The reference's route on the tokens ``idx``: ``mh.doc_proposals``
    on the same uniforms (its key's draw replaced by them), gathered, then
    the Pallas ``sample_warp_tiled`` in interpret mode on one window."""
    jidx = jmh.build_doc_index(x["doc"], x["mask"], x["M"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, dtype: jnp.asarray(x["u"][0]))
        t_doc = np.asarray(jmh.doc_proposals(
            jax.random.PRNGKey(0), jnp.asarray(x["topics"]),
            jnp.asarray(x["doc"]), jidx, n_topics=x["K"], alpha=alpha,
            n_cycles=x["C"]))
    scaled = (x["w_til"] / x["w_til"].sum(axis=1, keepdims=True)
              * x["K"]).astype(np.float32)
    jq = jmh.alias_queues(jnp.asarray(scaled))
    s, acc = pallas_warp(
        jnp.asarray(x["topics"][idx]), jnp.asarray(x["D"][x["doc"][idx]]),
        jnp.asarray(t_doc[:, idx]), jnp.asarray(x["u"][1][:, :, idx]),
        jnp.asarray(x["u"][2][:, :, idx]), jnp.asarray(x["w_hat"]),
        jnp.asarray(x["w_til"]), *jq, jnp.asarray(x["word"][idx]),
        jnp.int32(first), alpha=alpha, n_cycles=x["C"], win_words=win,
        tile_t=128, interpret=True)
    return np.asarray(s), np.asarray(acc)


@pytest.mark.parametrize("stream", ["docs", "one_real_token"])
@pytest.mark.parametrize("near_one", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_chain_tokens_bitwise_vs_pallas(tiled, near_one, stream):
    """The main-path chain (its twin on the CPU) on the real tokens of the
    streams against the reference's doc proposals and the Pallas kernel:
    topics and accepted counts bitwise, written at the tokens, padding
    untouched. Untiled against the full-vocabulary window; tiled (tiles of
    64 tokens, a 4-word window that some tiles' runs overflow) against
    one Pallas call per tile on that tile's window."""
    x = _stream(11 + near_one, near_one=near_one,
                one_real=stream == "one_real_token")
    alpha = 0.1
    idx = np.nonzero(x["mask"])[0].astype(np.int32)
    index = mh.build_doc_index(T(x["doc"]), T(x["mask"]), x["M"])
    if stream == "one_real_token":
        assert index.perm.shape[0] == 1
    else:
        assert {0, 1} <= set(index.length.tolist())
    tables = sw.alias_tables(T(x["w_til"]))
    args = (T(x["topics"]), T(x["doc"]), T(x["word"]), *map(T, x["u"]),
            T(x["D"]), T(x["w_hat"]), tables, index)
    out = (T(x["topics"]).clone(), torch.zeros(x["N"], dtype=torch.uint8))
    size, win = 64, 4
    if tiled:
        first = x["word"][idx][::size].copy()
        last = x["word"][idx][size - 1::size]
        if stream == "docs":        # tiles that fit the window and not
            assert 0 < (last - first[:last.shape[0]] >= win).sum() \
                < last.shape[0]
        sw.warp_chain_tokens_tiled(T(idx), T(first), size, *args,
                                   win_words=win, alpha=alpha, out=out)
        want = [_pallas_chain(x, idx[c * size:(c + 1) * size], first[c],
                              win, alpha) for c in range(first.shape[0])]
        j_s, j_acc = (np.concatenate(a) for a in zip(*want))
    else:
        sw.warp_chain_tokens(T(idx), *args, alpha=alpha, out=out)
        j_s, j_acc = _pallas_chain(x, idx, 0, x["V"], alpha)
    t_s, t_acc = out[0].numpy(), out[1].numpy()
    assert np.array_equal(t_s[idx], j_s)
    assert np.array_equal(t_acc[idx].astype(np.int32), j_acc)
    pad = x["mask"] == 0
    assert np.array_equal(t_s[pad], x["topics"][pad])
    assert not t_acc[pad].any()


def test_chain_tokens_equal_the_rows_contract():
    """The two entries of the chain kernel on the same tokens: the main
    path's, doc proposals drawn inside, against ``warp_chain_rows`` fed
    ``mh.doc_proposals`` and the gathered streams; tiled against untiled
    where the tiles fit."""
    x = _stream(3, V=200, N=1200)
    idx = np.nonzero(x["mask"])[0].astype(np.int32)
    index = mh.build_doc_index(T(x["doc"]), T(x["mask"]), x["M"])
    tables = mh.build_alias_tables(T(x["w_til"]))
    args = (T(x["topics"]), T(x["doc"]), T(x["word"]), *map(T, x["u"]),
            T(x["D"]), T(x["w_hat"]), tables, index)

    def fresh():
        return T(x["topics"]).clone(), torch.zeros(x["N"], dtype=torch.uint8)

    a = sw.warp_chain_tokens(T(idx), *args, alpha=0.3, out=fresh())
    i = torch.from_numpy(idx).long()
    t_doc = mh.doc_proposals(T(x["u"][0])[:, :, i], T(x["topics"]),
                             T(x["doc"])[i], index, n_topics=x["K"],
                             alpha=0.3)
    s, n_acc = sw.warp_chain_rows(
        T(x["topics"])[i], T(x["doc"])[i], T(x["word"])[i], t_doc,
        T(x["u"][1])[:, :, i], T(x["u"][2])[:, :, i], T(x["D"]),
        T(x["w_hat"]), tables, alpha=0.3)
    assert torch.equal(a[0][i], s) and torch.equal(a[1][i].int(), n_acc)
    size = 64
    first = T(x["word"][idx][::size].copy())
    b = sw.warp_chain_tokens_tiled(T(idx), first, size, *args,
                                   win_words=x["V"] // 2, alpha=0.3,
                                   out=fresh())
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_chain_tokens_checks():
    """Shapes and dtypes per launch; the ids and the doc index once per
    corpus (``check_doc_streams``), which the pipeline calls."""
    x = _stream(5, N=200)
    idx = T(np.nonzero(x["mask"])[0].astype(np.int32))
    index = mh.build_doc_index(T(x["doc"]), T(x["mask"]), x["M"])
    tables = mh.build_alias_tables(T(x["w_til"]))
    topics = T(x["topics"])
    args = [topics, T(x["doc"]), T(x["word"]), *map(T, x["u"]), T(x["D"]),
            T(x["w_hat"]), tables, index]
    out = (topics.clone(), torch.zeros(x["N"], dtype=torch.uint8))
    with pytest.raises(ValueError, match="u_doc"):
        sw.warp_chain_tokens(idx, *args[:3], args[3][:, :2], *args[4:],
                             alpha=0.1, out=out)
    with pytest.raises(ValueError, match="out"):
        sw.warp_chain_tokens(idx, *args, alpha=0.1,
                             out=(out[0], out[1].int()))
    with pytest.raises(ValueError, match="shares memory"):
        sw.warp_chain_tokens(idx, *args, alpha=0.1, out=(topics, out[1]))
    sw.check_doc_streams(T(x["doc"]), T(x["word"]), index, n_docs=x["M"],
                         n_words=x["V"])
    with pytest.raises(ValueError, match="word id"):
        sw.check_doc_streams(T(x["doc"]), T(x["word"]) + 1, index,
                             n_docs=x["M"], n_words=x["V"])
    bad = index._replace(perm=index.perm + x["N"])
    with pytest.raises(ValueError, match="perm"):
        sw.check_doc_streams(T(x["doc"]), T(x["word"]), bad, n_docs=x["M"],
                             n_words=x["V"])


def test_main_path_accepted_counts_saturate_at_255():
    """The main-path chain stores accepted counts as u8, saturating at
    255, where the reference signature returns int32. At mh_cycles = 128
    (256 proposals a token), with every proposal of every other token
    accepted (accept uniforms of 0 against positive ratios), the twin
    stores min(count, 255); the iteration reads only ``accepted > 0``, so
    ``frac_accepted`` equals the int32 count's; ``warp_chain_rows`` still
    returns the int32 count, 256 where all were accepted."""
    C = 128
    x = _stream(9, N=300, C=C)
    x["u"][2][:, :, ::2] = 0.0           # every proposal accepted
    idx = np.nonzero(x["mask"])[0].astype(np.int32)
    index = mh.build_doc_index(T(x["doc"]), T(x["mask"]), x["M"])
    tables = mh.build_alias_tables(T(x["w_til"]))
    args = (T(x["topics"]), T(x["doc"]), T(x["word"]), *map(T, x["u"]),
            T(x["D"]), T(x["w_hat"]), tables, index)
    out = (T(x["topics"]).clone(), torch.zeros(x["N"], dtype=torch.uint8))
    s, acc = sw.warp_chain_tokens(T(idx), *args, alpha=0.1, out=out)
    i = torch.from_numpy(idx).long()
    t_doc = mh.doc_proposals(T(x["u"][0])[:, :, i], T(x["topics"]),
                             T(x["doc"])[i], index, n_topics=x["K"],
                             alpha=0.1)
    s_rows, n_acc = sw.warp_chain_rows(
        T(x["topics"])[i], T(x["doc"])[i], T(x["word"])[i], t_doc,
        T(x["u"][1])[:, :, i], T(x["u"][2])[:, :, i], T(x["D"]),
        T(x["w_hat"]), tables, alpha=0.1)
    assert n_acc.dtype == torch.int32 and acc.dtype == torch.uint8
    assert bool((n_acc[i % 2 == 0] == 2 * C).all())
    assert bool((n_acc[i % 2 == 1] < 255).any())
    assert torch.equal(acc[i], torch.clamp(n_acc, max=255).to(torch.uint8))
    assert torch.equal(s[i], s_rows)
    mask = T(x["mask"])
    full = torch.zeros(x["N"], dtype=torch.int32)
    full[i] = n_acc
    u8 = mh.warp_stats(mask, acc > 0, s, T(x["topics"]), C)
    i32 = mh.warp_stats(mask, full > 0, s, T(x["topics"]), C)
    assert u8.frac_accepted == i32.frac_accepted
