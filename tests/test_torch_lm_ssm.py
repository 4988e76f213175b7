"""The port's Mamba2 module (``repro_torch.models.ssm``) and the ssm and
hybrid families (mamba2-370m, zamba2-1.2b) against the reference, on the
CPU.

Module checks on the same NumPy inputs and the reference's weights: the
causal depthwise conv with and without carried state (rtol/atol 1e-6),
the chunked SSD forward against ``ssm.ssm_train`` (1e-5; chunk 256, one
partial chunk, and chunks of 8 over 27 tokens) and against the port's
own one-token recurrence (2e-5), its gradients against ``jax.grad``
(rtol 1e-4, atol 1e-5 on gradients of order 1), and one recurrence step
against the reference's (1e-5), the cache written in place. Then the whole-model
checks of ``tests/_torch_lm_family.py`` for each config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from repro_torch.models.tree import tree_items, tree_leaves, tree_map
from _torch_lm_family import (build_case, carried, check_decode,
                              check_dtypes_after_step, check_forward,
                              check_grads, check_params_both_ways,
                              check_remat, close, t)

ARCHS = ["mamba2-370m", "zamba2-1.2b"]


def layer0(arch="mamba2-370m", **over):
    jcfg, jp, cfg, p = carried(arch, **over)
    return (jcfg, jax.tree.map(lambda x: x[0], jp["blocks"]["ssm"]), cfg,
            tree_map(lambda x: x[0], p["blocks"]["ssm"]))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 20)).astype(np.float32)
    w = rng.normal(size=(4, 20)).astype(np.float32)
    b = rng.normal(size=(20,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 20)).astype(np.float32) if with_state \
        else None
    want, want_st = jssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = ssm._causal_conv(t(x), t(w), t(b),
                                   None if st is None else t(st))
    close(got, want, rtol=1e-6, atol=1e-6)
    close(got_st, want_st, rtol=0, atol=0)


@pytest.mark.parametrize("L,chunk", [(40, 256), (27, 8), (300, 256)])
def test_ssm_train_matches_reference(L, chunk):
    """One chunk shorter than 256, chunks of 8 with a padded last one, and
    two chunks of 256 (the second partial)."""
    jcfg, jp, cfg, p = layer0()
    x = np.random.default_rng(L).normal(size=(2, L, cfg.d_model)
                                        ).astype(np.float32)
    want = jax.jit(lambda a: jssm.ssm_train(jp, a, jcfg, chunk=chunk))(
        jnp.asarray(x))
    with torch.no_grad():
        got = ssm.ssm_train(p, t(x), cfg, chunk=chunk)
    close(got, want, rtol=1e-5, atol=1e-5)


def test_ssm_train_gradients_match_jax_grad():
    """Through the chunk loop's carried state, the decay's minimum and
    the causal mask: every param leaf and the input, of Σ y·r with r
    standard normal (gradients of order 1: rtol 1e-4, atol 1e-5)."""
    jcfg, jp, cfg, p = layer0()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 27, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(2, 27, cfg.d_model)).astype(np.float32)
    jg, jgx = jax.grad(lambda prm, a: jnp.sum(
        jssm.ssm_train(prm, a, jcfg, chunk=8) * r), argnums=(0, 1))(
        jp, jnp.asarray(x))
    pp = tree_map(lambda v: v.detach().requires_grad_(), p)
    xp = t(x).requires_grad_()
    out = torch.sum(ssm.ssm_train(pp, xp, cfg, chunk=8) * t(r))
    names = [n for n, _ in tree_items(pp)]
    grads = torch.autograd.grad(out, [xp] + tree_leaves(pp))
    want = [np.asarray(jgx)] + [np.asarray(v) for _, v in tree_items(jg)]
    for name, g, w in zip(["x"] + names, grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_ssm_train_equals_the_recurrence():
    """The chunked scan and the one-token recurrence compute the same
    map: L steps of ``ssm_decode`` from a zero cache give ``ssm_train``'s
    outputs (chunks of 8 over 27 tokens: the state crosses 3 chunk
    boundaries)."""
    jcfg, jp, cfg, p = layer0()
    L = 27
    x = t(np.random.default_rng(4).normal(size=(2, L, cfg.d_model)
                                          ).astype(np.float32))
    cache = ssm.init_ssm_cache(cfg, 2, "cpu", n_layers=1)
    state, conv = cache["state"][0], cache["conv"][0]
    with torch.no_grad():
        want = ssm.ssm_train(p, x, cfg, chunk=8)
        for i in range(L):
            out, s2, c2 = ssm.ssm_decode(p, x[:, i:i + 1], state, conv, cfg)
            assert s2.data_ptr() == state.data_ptr()      # written in place
            assert c2.data_ptr() == conv.data_ptr()
            close(out[:, 0], want[:, i], rtol=2e-5, atol=2e-5)


def test_ssm_decode_matches_reference():
    jcfg, jp, cfg, p = layer0()
    rng = np.random.default_rng(5)
    state = rng.normal(size=(2, cfg.n_ssm_heads, cfg.ssm_state,
                             cfg.ssm_head_dim)).astype(np.float32)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = rng.normal(size=(2, cfg.conv_width - 1, conv_dim)
                      ).astype(np.float32)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    want = jssm.ssm_decode(jp, jnp.asarray(x), jnp.asarray(state),
                           jnp.asarray(conv), jcfg)
    sp, cp = t(state), t(conv)
    with torch.no_grad():
        got = ssm.ssm_decode(p, t(x), sp, cp, cfg)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-5)
    assert got[1] is sp and got[2] is cp


def test_ssm_cache_layout():
    jcfg, _, cfg, _ = carried("zamba2-1.2b")
    for n_layers in (None, 3):
        want = jssm.init_ssm_cache(jcfg, 2, n_layers)
        got = ssm.init_ssm_cache(cfg, 2, "cpu", n_layers)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype), k


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


def test_hybrid_grouping_and_cache():
    """zamba2 reduced: 5 layers in 2 groups of 2 and a remainder of 1; the
    cache holds one shared-attention KV slot a group, and decode writes
    both slots."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    _, _, cfg, p = carried("zamba2-1.2b")
    assert transformer._hybrid_split(cfg) == (2, 1)
    api = get_model(cfg, "cpu")
    cache = api.make_cache(2, 6)
    assert tuple(cache["k"].shape)[:3] == (2, 2, 6)
    assert tuple(cache["state"].shape)[:2] == (5, 2)
    _, cache = api.decode(p, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert bool((cache["k"][:, :, 0] != 0).any(-1).any(-1).all())
    assert bool((cache["k"][:, :, 1:] == 0).all())
    full = dataclasses.replace(cfg, n_layers=38, attn_every=6)
    assert transformer._hybrid_split(full) == (6, 2)
