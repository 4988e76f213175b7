"""The port's MLA attention (minicpm3-4b) and encoder-decoder
(whisper-base) against the reference, on the CPU.

Module checks on the reference's weights and the same NumPy inputs:
``mla_train`` within rtol/atol 1e-5 and its gradients against
``jax.grad`` (rtol 1e-4, atol 1e-6); ``mla_decode`` at the first, a
middle and the last slot, the compressed cache written in place (1e-5);
``encode`` (1e-5). The encoder-decoder's cross cache both ways: with the
reference's zero cache the port's decode gives the reference's logits;
with the cache filled (``encdec.fill_cross_cache``) the reference's own
decode step, handed that cache, gives the port's (1e-4).

The reference fault (ROADMAP.md Queue 3): nothing in the reference writes
the cross cache, so its decode never sees the encoder; pinned here on the
reference, and its repair pinned on the port (decode from a filled cache
reproduces ``encdec_loss``'s train path position by position). Then the
whole-model checks of ``tests/_torch_lm_family.py`` for each config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.registry import get_model as jget_model
from repro_torch.models import attention, encdec
from repro_torch.models.registry import get_model
from repro_torch.models.tree import tree_items, tree_leaves, tree_map
from _torch_lm_family import (build_case, carried, check_decode,
                              check_dtypes_after_step, check_forward,
                              check_grads, check_params_both_ways,
                              check_remat, close, t)

ARCHS = ["minicpm3-4b", "whisper-base"]
F32 = dict(rtol=1e-5, atol=1e-5)


def mla_layer0():
    jcfg, jp, cfg, p = carried("minicpm3-4b")
    return (jcfg, jax.tree.map(lambda x: x[0], jp["blocks"]["attn"]), cfg,
            tree_map(lambda x: x[0], p["blocks"]["attn"]))


def test_mla_train_matches_reference():
    """S = 600 over the blocks of 512 queries and 1,024 keys (one block
    padded), Dk = qk_nope + qk_rope = 24 ≠ Dv = 16."""
    jcfg, jp, cfg, p = mla_layer0()
    x = np.random.default_rng(0).normal(size=(2, 600, cfg.d_model)
                                        ).astype(np.float32)
    want = jax.jit(lambda a: jattn.mla_train(jp, a, jcfg))(jnp.asarray(x))
    with torch.no_grad():
        got = attention.mla_train(p, t(x), cfg)
    close(got, want, **F32)


def test_mla_train_gradients_match_jax_grad():
    jcfg, jp, cfg, p = mla_layer0()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32) * 1e-2
    jg, jgx = jax.grad(lambda prm, a: jnp.sum(jattn.mla_train(prm, a, jcfg)
                                              * r), argnums=(0, 1))(
        jp, jnp.asarray(x))
    pp = tree_map(lambda v: v.detach().requires_grad_(), p)
    xp = t(x).requires_grad_()
    out = torch.sum(attention.mla_train(pp, xp, cfg) * t(r))
    names = ["x"] + [n for n, _ in tree_items(pp)]
    grads = torch.autograd.grad(out, [xp] + tree_leaves(pp))
    want = [np.asarray(jgx)] + [np.asarray(v) for _, v in tree_items(jg)]
    for name, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_mla_decode_matches_reference():
    jcfg, jp, cfg, p = mla_layer0()
    rng = np.random.default_rng(2)
    b, s_max = 2, 12
    ckv = rng.normal(size=(b, s_max, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.normal(size=(b, s_max, cfg.qk_rope_dim)).astype(np.float32)
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    jdecode = jax.jit(lambda *a: jattn.mla_decode(*a, jcfg))
    for length in (0, 5, s_max - 1):
        want = jdecode(jp, jnp.asarray(x), jnp.asarray(ckv),
                       jnp.asarray(krope), jnp.int32(length))
        cp, kp = t(ckv), t(krope)
        with torch.no_grad():
            got = attention.mla_decode(
                p, t(x), cp, kp, torch.tensor(length, dtype=torch.int32),
                cfg)
        for g, w in zip(got, want):
            close(g, w, **F32)
        assert got[1] is cp and got[2] is kp            # written in place


def test_mla_cache_is_compressed():
    """c_kv (L, B, S, r_kv) and the shared k_rope (L, B, S, qr): at the
    published width 288 values a token a layer, against 40·(96 + 64) =
    6,400 for the expanded K and V."""
    from repro_torch.configs import REGISTRY
    jcfg, _, cfg, _ = carried("minicpm3-4b")
    want = jattn.init_mla_cache(jcfg, 2, 10)
    got = attention.init_mla_cache(cfg, 2, 10, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert str(got["c_kv"].dtype) == "torch.float32"
    full = REGISTRY["minicpm3-4b"]
    assert full.kv_lora_rank + full.qk_rope_dim == 288
    assert full.n_heads * (full.qk_nope_dim + full.qk_rope_dim
                           + full.v_head_dim) == 6_400


# -- the encoder-decoder ---------------------------------------------------------

def whisper(seed=0):
    return carried("whisper-base", seed=seed)


def test_encode_matches_reference():
    jcfg, jp, cfg, p = whisper()
    frames = np.random.default_rng(3).normal(size=(2, 30, cfg.d_model)
                                             ).astype(np.float32)
    want = jax.jit(lambda a: jencdec.encode(jp, a, jcfg))(
        jnp.asarray(frames))
    with torch.no_grad():
        got = get_model(cfg, "cpu").prefill(p, t(frames))
    close(got, want, **F32)


def _frames(cfg, seed, b=2, s=12):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)
                                              ).astype(np.float32)


def test_reference_decode_never_sees_the_encoder():
    """The reference fault: ``init_encdec_cache`` makes ``x_k``/``x_v``
    zeros (src/repro/models/encdec.py:128-134), ``encdec_decode_step``
    only reads them and hands them back (:153-157, :187-188), and its
    ``prefill`` is ``encode``, which writes no cache (registry.py:46). So
    the decoded logits are the same for any frames, where the train path
    depends on them."""
    jcfg, jp, cfg, p = whisper()
    japi = jget_model(jcfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 5)
                                             ).astype(np.int32)
    logits, train = [], []
    for seed in (10, 11):
        frames = jnp.asarray(_frames(cfg, seed))
        enc = japi.prefill(jp, frames)                 # what serving runs
        cache = japi.make_cache(2, 8, enc_len=12)
        out = []
        for i in range(5):
            lg, cache = japi.decode(jp, cache, jnp.asarray(toks[:, i:i + 1]))
            out.append(np.asarray(lg))
        assert not np.asarray(cache["x_k"]).any()
        assert not np.asarray(cache["x_v"]).any()
        logits.append(np.stack(out))
        h = jencdec._decode_blocks(
            jp, jnp.take(jp["embed"]["table"], jnp.asarray(toks), axis=0),
            enc, jcfg)
        train.append(np.asarray(h @ jp["head"]["w"]))
    assert np.array_equal(logits[0], logits[1])
    assert np.abs(train[0] - train[1]).max() > 1e-2


def test_port_decode_with_the_reference_zero_cache_equals_it():
    """Left unfilled, the port's cache is the reference's, and the port's
    decode gives the reference's logits."""
    jcfg, jp, cfg, p = whisper()
    japi, api = jget_model(jcfg), get_model(cfg, "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 6)
                                             ).astype(np.int32)
    jcache, cache = japi.make_cache(2, 7, enc_len=12), \
        api.make_cache(2, 7, enc_len=12)
    for i in range(6):
        want, jcache = japi.decode(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, cache = api.decode(p, cache, t(toks[:, i:i + 1]))
        close(got, want, rtol=1e-4, atol=1e-4)
    for k in ("k", "v", "x_k", "x_v"):
        close(cache[k], jcache[k], rtol=1e-4, atol=1e-4)


def test_filled_cache_decode_reproduces_the_train_path():
    """The repair: ``fill_cross_cache`` writes each decoder layer's
    ``wk``/``wv`` of the encoder output; decode from it gives
    ``encdec_loss``'s train path at every position (within 2e-2, the
    reference test's decode tolerance, and 1e-4 in fact), the cross
    entropy of its logits equals ``encdec_loss`` (1e-5), and other
    frames give other logits."""
    jcfg, jp, cfg, p = whisper(seed=1)
    api = get_model(cfg, "cpu")
    B, T = 2, 9
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    frames = t(_frames(cfg, 7, B, 16))
    batch = {"frames": frames, "tokens": t(toks), "labels": t(labels),
             "mask": torch.ones((B, T), dtype=torch.int32)}
    with torch.no_grad():
        enc = encdec.encode(p, frames, cfg)
        train = encdec.decode_hidden(p, t(toks), enc, cfg) @ p["head"]["w"]
        loss = api.loss(p, batch)
    cache = api.make_cache(B, T, enc_len=16)
    got_enc = encdec.fill_cross_cache(p, cache, frames, cfg)
    assert torch.equal(got_enc, enc)
    steps = []
    for i in range(T):
        lg, cache = api.decode(p, cache, t(toks[:, i:i + 1]))
        np.testing.assert_allclose(lg.numpy(), train[:, i].numpy(),
                                   rtol=2e-2, atol=2e-2)
        close(lg, train[:, i], rtol=1e-4, atol=1e-4)
        steps.append(lg)
    logits = torch.stack(steps, 1)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(B * T, -1), t(labels).long().reshape(-1))
    close(ce, loss, **F32)
    other = api.make_cache(B, T, enc_len=16)
    encdec.fill_cross_cache(p, other, t(_frames(cfg, 8, B, 16)), cfg)
    lg2, _ = api.decode(p, other, t(toks[:, :1]))
    assert (lg2 - steps[0]).abs().max() > 1e-2
    with pytest.raises(ValueError, match="enc_len"):
        encdec.fill_cross_cache(p, api.make_cache(B, T, enc_len=8), frames,
                                cfg)


# -- the whole model, per config ---------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return build_case(request.param)


def test_hidden_logits_and_loss(case):
    check_forward(case)


def test_every_gradient_leaf(case):
    check_grads(case)


def test_remat_full_equals_none_bitwise(case):
    check_remat(case)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_train_path(arch):
    check_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_both_ways_bitwise(arch):
    check_params_both_ways(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_dtypes_after_one_train_step(arch):
    check_dtypes_after_step(arch)
