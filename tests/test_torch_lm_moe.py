"""The port's MoE FFN (``repro_torch.models.moe``, the local path) and the
MoE family (deepseek-moe-16b, granite-moe-3b-a800m with its dead pad
experts) against the reference, on the CPU.

Module checks on the reference's weights and the same NumPy inputs:

* the router's top-k keeps ``jax.lax.top_k``'s tie rule (the lower
  expert first), bitwise on exact ties;
* ``moe_ffn`` against the reference's local path within rtol/atol 1e-5,
  lossless (T·k ≤ 4,096) and with capacity drops (T·k past 4,096 and
  ``capacity_factor`` 0.5: the dump row used), and against the
  dense-evaluation oracle of ``tests/test_models.py`` (2e-3, its
  tolerance); its gradients against ``jax.grad`` (rtol 1e-4, atol 1e-6);
* ``router_load_stats`` bitwise (counts and capacity; the fractions
  within 1e-7).

Float32 router probabilities may rank two experts differently in the
two packages where the k-th and (k+1)-th lie within 1e-6: such tokens
are counted (at most 1% of them) and left out of the comparison; where
capacity drops, one flip moves later tokens' slots, so those cases
require none. Then the whole-model checks of
``tests/_torch_lm_family.py`` for each config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.models.tree import tree_items, tree_leaves, tree_map
from _torch_lm_family import (build_case, carried, check_decode,
                              check_dtypes_after_step, check_forward,
                              check_grads, check_params_both_ways,
                              check_remat, close, t)

ARCHS = ["deepseek-moe-16b", "granite-moe-3b-a800m"]
TIE_GAP = 1e-6


def layer0(arch, **over):
    jcfg, jp, cfg, p = carried(arch, **over)
    return (jcfg, jax.tree.map(lambda x: x[0], jp["blocks"]["moe"]), cfg,
            tree_map(lambda x: x[0], p["blocks"]["moe"]))


def near_ties(jp, x, jcfg) -> np.ndarray:
    """Tokens whose k-th and (k+1)-th router probabilities (the
    reference's) lie within TIE_GAP."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = xf @ jp["router"]
    logits = jnp.where(jnp.arange(logits.shape[-1]) < jcfg.n_experts,
                       logits, -1e30)
    probs = np.sort(np.asarray(jax.nn.softmax(logits, -1)), -1)[:, ::-1]
    k = jcfg.moe_top_k
    return probs[:, k - 1] - probs[:, k] < TIE_GAP


def test_top_k_keeps_the_lower_index_first_on_ties():
    """A router with repeated columns: every token's probabilities tie in
    pairs; the port's order is lax.top_k's, bitwise."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(16, 4)).astype(np.float32)
    router = np.concatenate([base, base, base[:, :1]], axis=1)  # 9 experts
    x = rng.normal(size=(32, 16)).astype(np.float32)
    for k in (1, 2, 3, 5):
        w, sel = moe.router_top_k(t(x), t(router), k, e_total=8)
        logits = jnp.asarray(x) @ jnp.asarray(router)
        logits = jnp.where(jnp.arange(9) < 8, logits, -1e30)
        jw, jsel = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
        assert np.array_equal(sel.numpy(), np.asarray(jsel)), k
        close(w, jw, rtol=1e-6, atol=1e-7)
        assert bool((sel < 8).all())            # the dead expert never


@pytest.mark.parametrize("arch,b,s,cf", [
    ("deepseek-moe-16b", 2, 24, 1.25),       # lossless, shared expert
    ("granite-moe-3b-a800m", 2, 24, 1.25),   # lossless, dead pad experts
    ("granite-moe-3b-a800m", 4, 600, 0.5),   # T·k = 4,800: drops
    ("deepseek-moe-16b", 3, 700, 1.25)])     # T·k = 4,200: cf·T·k/E
def test_moe_ffn_matches_reference(arch, b, s, cf):
    jcfg, jp, cfg, p = layer0(arch, capacity_factor=cf)
    x = np.random.default_rng(s).normal(size=(b, s, cfg.d_model)
                                        ).astype(np.float32)
    ties = near_ties(jp, x, jcfg)
    t_all = b * s
    cap = moe._capacity(cfg, t_all, cfg.moe_top_k, cfg.n_experts)
    assert cap == jmoe._capacity(jcfg, t_all, jcfg.moe_top_k,
                                 jcfg.n_experts)
    lossless = cap == t_all * cfg.moe_top_k
    assert ties.sum() <= t_all // 100 if lossless else ties.sum() == 0
    want = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)).reshape(
        t_all, -1)
    with torch.no_grad():
        got = moe.moe_ffn(p, t(x), cfg).reshape(t_all, -1)
    close(got[~torch.from_numpy(ties)], want[~ties], rtol=1e-5, atol=1e-5)
    if cf < 1:
        stats = jmoe.router_load_stats(jp, jnp.asarray(x), jcfg)
        assert float(stats["overflow_frac"]) > 0     # the dump row is used


def test_moe_ffn_matches_dense_eval():
    """As tests/test_models.py:109: with capacity ≥ T·k (nothing dropped)
    the routed FFN equals the explicit per-token evaluation of the
    selected experts (reduced granite: 8 experts, top 2)."""
    jcfg, jp, cfg, p = layer0("granite-moe-3b-a800m", capacity_factor=64.0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y = moe.moe_ffn(p, t(x), cfg).numpy()
    tk = 2 * 8
    xf = x.reshape(tk, cfg.d_model)
    logits = xf @ p["router"].numpy()
    logits = np.where(np.arange(logits.shape[-1]) < cfg.n_experts, logits,
                      -1e30)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    sel = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.moe_top_k]
    w = np.take_along_axis(probs, sel, axis=-1)
    w /= w.sum(-1, keepdims=True)
    wg, wu, wd = (p["w_gate"].numpy(), p["w_up"].numpy(),
                  p["w_down"].numpy())
    out = np.zeros_like(xf)
    for i in range(tk):
        for j, e in enumerate(sel[i]):
            hgate = xf[i] @ wg[e]
            silu = hgate / (1 + np.exp(-hgate)) * (xf[i] @ wu[e])
            out[i] += w[i, j] * (silu @ wd[e])
    np.testing.assert_allclose(y.reshape(tk, -1), out, rtol=2e-3, atol=2e-3)


def test_moe_ffn_gradients_match_jax_grad():
    """Through the dispatch scatters, the expert products, the gather and
    the top-k weights (and the shared expert), lossless."""
    jcfg, jp, cfg, p = layer0("deepseek-moe-16b")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32) * 1e-2
    assert not near_ties(jp, x, jcfg).any()
    jg, jgx = jax.grad(lambda prm, a: jnp.sum(jmoe.moe_ffn(prm, a, jcfg)
                                              * r), argnums=(0, 1))(
        jp, jnp.asarray(x))
    pp = tree_map(lambda v: v.detach().requires_grad_(), p)
    xp = t(x).requires_grad_()
    out = torch.sum(moe.moe_ffn(pp, xp, cfg) * t(r))
    names = ["x"] + [n for n, _ in tree_items(pp)]
    grads = torch.autograd.grad(out, [xp] + tree_leaves(pp))
    want = [np.asarray(jgx)] + [np.asarray(v) for _, v in tree_items(jg)]
    for name, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_load_stats_bitwise(arch):
    jcfg, jp, cfg, p = layer0(arch)
    x = np.random.default_rng(3).normal(size=(4, 64, cfg.d_model)
                                        ).astype(np.float32)
    assert not near_ties(jp, x, jcfg).any()
    want = jmoe.router_load_stats(jp, jnp.asarray(x), jcfg)
    got = moe.router_load_stats(p, t(x), cfg)
    assert np.array_equal(got["counts"].numpy(), np.asarray(want["counts"]))
    assert got["capacity"] == want["capacity"]
    for k in ("overflow_frac", "imbalance"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-7, k
    assert int(got["counts"].sum()) == 4 * 64 * cfg.moe_top_k


def test_granite_pad_experts_are_dead():
    """Full width: 40 experts padded to 48; the 8 pad experts' logits are
    -1e30, so no token reaches them (reduced width, the published E)."""
    from repro_torch.configs import REGISTRY
    assert REGISTRY["granite-moe-3b-a800m"].padded_experts == 48
    jcfg, jp, cfg, p = layer0("granite-moe-3b-a800m", n_experts=5,
                              expert_pad_multiple=4)
    assert cfg.padded_experts == 8 and p["w_gate"].shape[0] == 8
    x = np.random.default_rng(4).normal(size=(2, 50, cfg.d_model)
                                        ).astype(np.float32)
    _, sel = moe.router_top_k(t(x).reshape(-1, cfg.d_model), p["router"],
                              cfg.moe_top_k, cfg.n_experts)
    assert int(sel.max()) < 5
    with torch.no_grad():
        got = moe.moe_ffn(p, t(x), cfg)
    want = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ties = near_ties(jp, x, jcfg)
    close(got.reshape(100, -1)[~torch.from_numpy(ties)],
          np.asarray(want).reshape(100, -1)[~ties], rtol=1e-5, atol=1e-5)


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


def test_full_width_capacity():
    """The decode and train capacities of the published configs: lossless
    at batch 4 (deepseek decode), cf·T·k/E past 4,096 (a train step)."""
    from repro_torch.configs import REGISTRY
    ds = REGISTRY["deepseek-moe-16b"]
    assert moe._capacity(ds, 4, 6, 64) == 24
    assert moe._capacity(ds, 2 * 4096, 6, 64) == int(1.25 * 8192 * 6 / 64)
    cfg = dataclasses.replace(ds, capacity_factor=0.01)
    assert moe._capacity(cfg, 8192, 6, 64) == 8
