"""The port's LM zoo (``repro_torch.models``) against the reference's
(``repro.models``), on the CPU.

The same NumPy inputs, and the same weights carried across by
``repro_torch.models.convert``, go through each reference function and
its port: the layers, blockwise flash attention, KV-cache decode, the
whole dense decoder (``qwen1.5-0.5b``'s reduced config: tokens in, tied
head) and the embedding-input one (``pixtral-12b``'s: embeddings in,
untied head), their loss and every gradient leaf, and decode position by
position. Then the data half: ``param_count``, ``reduced_config`` and
``input_specs`` for all ten configs, and one train and one decode step
of each other family (their parity tests are
``tests/test_torch_lm_{ssm,moe,mla_encdec}.py``).

Tolerances: float32 (``param_dtype="float32"``) is the tight tier —
layers and attention within rtol/atol 1e-5 (2e-5 for blockwise
attention, whose running sums add in another order than one matmul),
logits and loss within rtol/atol 1e-5, gradients within rtol 1e-4 /
atol 1e-6, decode within 1e-4 of the reference's decode; decode against
the train path within the reference test's 2e-2. The one bfloat16 case
holds the loss within atol 2e-2. Counts and shapes are exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.registry import get_model as jget_model
from repro.models.registry import input_specs as jinput_specs
from repro.models.registry import reduced_config as jreduced
from repro_torch.configs import REGISTRY
from repro_torch.models import attention, layers, transformer
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.registry import get_model, input_specs, reduced_config
from repro_torch.models.tree import (tree_items, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.launch.train import train_lm
from repro_torch.train.serve_step import make_serve_step

F32 = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def port_cfg(jcfg):
    """The port's ModelConfig with the same field values."""
    return dataclasses.replace(REGISTRY[jcfg.name],
                               **dataclasses.asdict(jcfg))


def carried(arch, dtype="float32", seed=0, **over):
    """(jax cfg, jax params, port cfg, port params): the reference's init
    carried into the port."""
    jcfg = dataclasses.replace(jreduced(JREGISTRY[arch], **over),
                               param_dtype=dtype)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(seed))
    cfg = port_cfg(jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, jp, cfg, params_from_reference(tree, cfg, "cpu")


def token_batch(cfg, b, s, seed=0, partial_mask=False):
    rng = np.random.default_rng(seed)
    if cfg.input_is_embeddings:
        inputs = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if partial_mask:
        mask[:, : s // 3] = 0
    return {"inputs": inputs,
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "mask": mask}


# -- layers ----------------------------------------------------------------

def test_rms_norm_layer_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    close(layers.rms_norm({"scale": t(scale)}, t(x), 1e-5),
          jlayers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-5), **F32)
    close(layers.layer_norm({"scale": t(scale), "bias": t(bias)}, t(x), 1e-5),
          jlayers.layer_norm({"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}, jnp.asarray(x),
                             1e-5), **F32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        # positions up to 4096 make angles of ~4e3 rad: float32 sin/cos of
        # such arguments differ by an ulp of the angle between libraries
        close(layers.rope(t(x), t(pos), theta),
              jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta),
              rtol=1e-5, atol=2e-4)
        small = np.arange(7, dtype=np.int32)[None]
        close(layers.rope(t(x), t(small), theta),
              jlayers.rope(jnp.asarray(x), jnp.asarray(small), theta), **F32)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_both_activations(act):
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 16, 40, jnp.float32, act=act)
    p = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).normal(size=(3, 5, 16)).astype(np.float32)
    close(layers.mlp(p, t(x), act=act),
          jlayers.mlp(jp, jnp.asarray(x), act=act), **F32)


def test_embed_and_linear():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 6)).astype(np.int32)
    close(layers.embed({"table": t(table)}, t(toks)),
          jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks)),
          rtol=0, atol=0)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    close(layers.linear({"w": t(w), "b": t(b)}, t(x)),
          jlayers.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x)), **F32)


@pytest.mark.parametrize("s,chunk", [(75, 16), (64, 64), (10, 256)])
def test_cross_entropy_chunked(s, chunk):
    """S not a multiple of the chunk, a partial mask, and one chunk."""
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 96
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    m = (rng.random((b, s)) < 0.7).astype(np.int32)
    want = jlayers.cross_entropy_chunked(jnp.asarray(h), jnp.asarray(w),
                                         jnp.asarray(y), jnp.asarray(m),
                                         chunk=chunk)
    hp, wp = t(h).requires_grad_(), t(w).requires_grad_()
    got = layers.cross_entropy_chunked(hp, wp, t(y), t(m), chunk=chunk)
    close(got, want, **F32)
    # the chunks' gradients (formed in the forward) against jax.grad
    gh, gw = torch.autograd.grad(got, (hp, wp))
    jh, jw = jax.grad(lambda a, c: jlayers.cross_entropy_chunked(
        a, c, jnp.asarray(y), jnp.asarray(m), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    close(gh, jh, rtol=1e-4, atol=1e-6)
    close(gw, jw, rtol=1e-4, atol=1e-6)


def test_loss_runs_over_the_padded_vocab_as_the_reference_does(tmp_path):
    """The training loss's logsumexp runs over every padded column of the
    head, not only the real vocab that decode and prefill unmask
    (ROADMAP.md Queue 3): the reference's ``cross_entropy_chunked``, the
    port's on one device, and the port's vocab-parallel loss (the head
    split over a model axis of 2 in a gloo world) all give the
    padded-vocab loss, which here differs from the real-vocab one by
    more than 1."""
    from _torch_dist import run_world
    rng = np.random.default_rng(3)
    b, s, d, v, v_pad = 2, 40, 16, 96, 128
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(d, v_pad)).astype(np.float32)
    w[:, v:] *= 4.0                        # the pad columns' logits: large
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    m = (rng.random((b, s)) < 0.8).astype(np.int32)
    logits = (h @ w).astype(np.float64)
    gold = np.take_along_axis(logits, y[..., None], -1)[..., 0]

    def mean_nll(cols):
        z = logits[..., :cols]
        top = z.max(-1, keepdims=True)
        lse = np.log(np.exp(z - top).sum(-1)) + top[..., 0]
        return float(((lse - gold) * m).sum() / m.sum())

    padded, real = mean_nll(v_pad), mean_nll(v)
    assert padded - real > 1.0
    ref = float(jlayers.cross_entropy_chunked(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), jnp.asarray(m),
        chunk=16))
    one = float(layers.cross_entropy_chunked(t(h), t(w), t(y), t(m),
                                             chunk=16, vocab=v_pad))
    np.savez(tmp_path / "loss.npz", h=h, w=w, y=y, m=m)
    ranks = run_world(2, "_torch_lm_dist:vocab_loss",
                      (str(tmp_path / "loss.npz"),), tmp_path, timeout=120)
    for got in (ref, one, *(r["loss"] for r in ranks)):
        assert abs(got - padded) <= 1e-5 * padded, (got, padded, real)
    # the vocab-parallel gradients are the one-device ones
    hp, wp = t(h).requires_grad_(), t(w).requires_grad_()
    gh, gw = torch.autograd.grad(layers.cross_entropy_chunked(
        hp, wp, t(y), t(m), chunk=16), (hp, wp))
    for r in ranks:
        close(t(r["gh"]), gh.numpy(), rtol=1e-5, atol=1e-7)
        close(t(r["gw"]), gw.numpy(), rtol=1e-5, atol=1e-7)


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(causal):
    """As tests/test_models.py:142: S = 75 over blocks of 32 and 16 (both
    padded), 2 KV heads of 3 query heads each."""
    rng = np.random.default_rng(0)
    b, s, hkv, g, d = 2, 75, 2, 3, 16
    q = rng.normal(size=(b, s, hkv, g, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, q_block=32,
                                 kv_block=16)
    got = attention.flash_attention(t(q), t(k), t(v), causal=causal,
                                    q_block=32, kv_block=16)
    assert got.shape == (b, s, hkv, g, d) and got.dtype == torch.float32
    close(got, want, rtol=2e-5, atol=2e-5)


def test_attn_decode_matches_reference():
    jcfg, jp, cfg, p = carried("qwen1.5-0.5b")
    ja = jax.tree.map(lambda x: x[0], jp["blocks"]["attn"])
    pa = tree_map(lambda x: x[0], p["blocks"]["attn"])
    rng = np.random.default_rng(4)
    b, s_max = 2, 12
    shape = (b, s_max, cfg.n_kv_heads, cfg.head_dim_)
    kc = rng.normal(size=shape).astype(np.float32)
    vc = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    jdecode = jax.jit(lambda *a: jattn.attn_decode(*a, jcfg))
    for length in (0, 5, s_max - 1):
        wo, wk, wv = jdecode(ja, jnp.asarray(x), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.int32(length))
        kp, vp = t(kc), t(vc)
        go, gk, gv = attention.attn_decode(
            pa, t(x), kp, vp, torch.tensor(length, dtype=torch.int32), cfg)
        close(go, wo, **F32)
        close(gk, wk, **F32)
        close(gv, wv, **F32)
        assert gk.data_ptr() == kp.data_ptr()          # written in place


# -- the whole model -----------------------------------------------------------

ARCHS = ["qwen1.5-0.5b", "pixtral-12b"]


@pytest.fixture(scope="module", params=ARCHS)
def model_case(request):
    arch = request.param
    jcfg, jp, cfg, p = carried(arch)
    batch = token_batch(cfg, 2, 40, partial_mask=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if jcfg.input_is_embeddings:
        jbatch["inputs"] = jbatch["inputs"].astype(jcfg.dtype)
    jh = jax.jit(lambda prm, x: jtf.forward_train(prm, x, jcfg))(
        jp, jbatch["inputs"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda prm, bt: jtf.loss_fn(prm, bt, jcfg)))(jp, jbatch)
    return dict(arch=arch, jcfg=jcfg, jp=jp, cfg=cfg, p=p, batch=batch,
                jh=jh, jhead=jtf._head_w(jp, jcfg), jloss=jloss,
                jgrads=jgrads)


def port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def test_forward_train_logits_and_loss(model_case):
    c = model_case
    cfg, p, batch = c["cfg"], c["p"], port_batch(c["batch"])
    with torch.no_grad():
        h = transformer.forward_train(p, batch["inputs"], cfg)
        logits = h @ transformer.head_w(p, cfg)
        loss = transformer.loss_fn(p, batch, cfg)
    close(h, c["jh"], **F32)
    close(logits, c["jh"] @ c["jhead"], **F32)
    close(loss, c["jloss"], **F32)


def test_every_gradient_leaf_matches_jax_grad(model_case):
    c = model_case
    cfg = c["cfg"]
    leaves = [x.detach().requires_grad_() for x in tree_leaves(c["p"])]
    params = tree_unflatten(c["p"], leaves)
    loss = transformer.loss_fn(params, port_batch(c["batch"]), cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # the embedding-input model never reads its table: jax.grad gives 0
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    want = dict(tree_items(jax.tree.map(np.asarray, c["jgrads"])))
    names = [n for n, _ in tree_items(params)]
    assert names == sorted(want) and len(names) == len(grads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_remat_none_gives_the_same_gradients(model_case):
    """Checkpointed blocks recompute what the plain forward computes."""
    c = model_case
    out = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(c["cfg"], remat=remat)
        leaves = [x.detach().requires_grad_() for x in tree_leaves(c["p"])]
        params = tree_unflatten(c["p"], leaves)
        loss = transformer.loss_fn(params, port_batch(c["batch"]), cfg)
        out[remat] = [loss] + [g for g in torch.autograd.grad(
            loss, leaves, allow_unused=True) if g is not None]
    for a, b in zip(out["full"], out["none"]):
        assert torch.equal(a, b)


def test_bf16_loss_within_2e2():
    jcfg, jp, cfg, p = carried("qwen1.5-0.5b", dtype="bfloat16")
    assert p["embed"]["table"].dtype == torch.bfloat16
    batch = token_batch(cfg, 2, 40)
    want = jax.jit(lambda prm, bt: jtf.loss_fn(prm, bt, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = transformer.loss_fn(p, port_batch(batch), cfg)
    assert abs(float(got) - float(want)) < 2e-2, (float(got), float(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_and_train_path(arch):
    """Token by token from an empty cache: the port's logits equal the
    reference's decode and the port's own forward_train at each position
    (padded vocab columns masked in both)."""
    jcfg, jp, cfg, p = carried(arch, seed=1, vocab_size=64,
                               vocab_pad_multiple=64)
    B, T = 2, 9
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    with torch.no_grad():
        if cfg.input_is_embeddings:
            # decode embeds tokens; the train path takes those embeddings
            h = transformer.forward_train(
                p, layers.embed(p["embed"], t(toks)), cfg)
        else:
            h = transformer.forward_train(p, t(toks), cfg)
        train_logits = (h @ transformer.head_w(p, cfg)).numpy()
    japi, api = jget_model(jcfg), get_model(cfg, "cpu")
    jcache, cache = japi.make_cache(B, T + 1), api.make_cache(B, T + 1)
    jdec = jax.jit(japi.decode)
    V = cfg.vocab_size
    for i in range(T):
        want, jcache = jdec(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, cache = api.decode(p, cache, t(toks[:, i:i + 1]))
        close(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[:, :V].numpy(), train_logits[:, i, :V],
                                   rtol=2e-2, atol=2e-2,
                                   err_msg=f"{arch} diverged at {i}")
        assert bool((got[:, V:] == -1e30).all())
    assert int(cache["length"]) == T


def test_prefill_is_the_last_position():
    jcfg, jp, cfg, p = carried("qwen1.5-0.5b")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = jtf.prefill(jp, jnp.asarray(toks), jcfg)
    close(get_model(cfg, "cpu").prefill(p, t(toks)), want, **F32)


def test_params_cross_both_ways_bitwise():
    for dtype in ("float32", "bfloat16"):
        jcfg, jp, cfg, p = carried("pixtral-12b", dtype=dtype)
        back = params_to_reference(p)
        for (name, a), (_, b) in zip(tree_items(back),
                                     tree_items(jax.tree.map(np.asarray,
                                                             jp))):
            assert a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), b.view(np.uint8)), name
        with pytest.raises(ValueError, match="float32"):
            params_from_reference(jax.tree.map(np.asarray, jp),
                                  dataclasses.replace(
                                      cfg, param_dtype="float32"
                                      if dtype == "bfloat16" else
                                      "bfloat16"), "cpu")


def test_port_init_shapes_and_scale():
    """The port's own init: the reference's tree, shapes and dtypes, and
    its scales (truncated normal × d_in^-0.5, embeddings × 0.02)."""
    for arch in ARCHS:
        jcfg = jreduced(JREGISTRY[arch])
        want = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
        p = get_model(port_cfg(jcfg), "cpu").init(0)
        got = tree_items(p)
        assert [(n, tuple(x.shape)) for n, x in got] == tree_items(
            jax.tree.map(lambda s: s.shape, want))
        assert all(x.dtype == torch.bfloat16 for _, x in got)
        w = p["blocks"]["attn"]["wq"]["w"].float()
        assert abs(w.std().item() * math.sqrt(jcfg.d_model) - 0.88) < 0.1
        assert float(w.abs().max()) <= 2 * jcfg.d_model ** -0.5 + 1e-3
        assert abs(p["embed"]["table"].float().std().item() - 0.02) < 2e-3


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_configs_param_count_and_reduced(arch):
    assert sorted(REGISTRY) == sorted(JREGISTRY)
    jcfg, cfg = JREGISTRY[arch], REGISTRY[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name in ("head_dim_", "padded_vocab", "padded_experts", "d_inner",
                 "n_ssm_heads", "sub_quadratic"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.dtype == getattr(torch, jcfg.param_dtype)
    assert dataclasses.asdict(reduced_config(cfg)) == dataclasses.asdict(
        jreduced(jcfg))
    assert dataclasses.asdict(reduced_config(cfg, n_layers=3, d_model=32)) \
        == dataclasses.asdict(jreduced(jcfg, n_layers=3, d_model=32))
    for kind in ("train", "prefill", "decode"):
        got = input_specs(cfg, 64, 4, kind)
        want = jinput_specs(jcfg, 64, 4, kind)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype)


def test_qwen_full_width_numbers():
    cfg = REGISTRY["qwen1.5-0.5b"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.padded_vocab) == \
        (24, 1024, 16, 16, 64, 2816, 151_936, 153_600)
    assert cfg.qkv_bias and cfg.tie_embeddings and cfg.rope_theta == 1e6
    assert cfg.param_count() == 465_616_896


@pytest.mark.parametrize("arch,what", [
    ("deepseek-moe-16b", "moe"), ("granite-moe-3b-a800m", "moe"),
    ("mamba2-370m", "ssm"), ("zamba2-1.2b", "hybrid"),
    ("minicpm3-4b", "MLA"), ("whisper-base", "encoder-decoder")])
def test_families_not_ported_name_14b(arch, what):
    """The six configs once refused naming #14b: each is accepted by
    get_model and train_lm and runs one train step and one decode step on
    the CPU, and nothing in the port names #14b any more. (The name is
    the one this test had while those configs were refused; it is kept
    so that the test's record runs on unbroken.)"""
    import pathlib
    import re
    cfg = reduced_config(REGISTRY[arch])
    api = get_model(cfg, "cpu")
    hist = train_lm(arch, steps=1, seq_len=16, global_batch=2,
                    device="cpu", log_fn=lambda _: None)
    assert np.isfinite(hist["loss"]).all() and hist["step"] == [1]
    params = hist["state"]["params"]
    cache = (api.make_cache(2, 4, enc_len=16) if cfg.is_encoder_decoder
             else api.make_cache(2, 4))
    logits, cache = make_serve_step(api)(
        params, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    assert int(cache["length"]) == 1
    src = pathlib.Path(transformer.__file__).resolve().parents[1]
    hits = [f"{f}:{i}" for f in sorted(src.rglob("*.py"))
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if re.search(r"#14b\b", line)]
    assert hits == [], (what, hits)


def test_check_family_refuses_what_the_reference_lacks():
    cfg = reduced_config(REGISTRY["qwen1.5-0.5b"])
    for bad in (dataclasses.replace(cfg, attn_kind="sliding"),
                dataclasses.replace(cfg, family="diffusion")):
        with pytest.raises(NotImplementedError, match="reference"):
            get_model(bad, "cpu")
        with pytest.raises(NotImplementedError, match="reference"):
            transformer.init_lm(bad, 0, torch.device("cpu"))


def test_dense_family_configs_are_accepted():
    for arch in ("qwen1.5-0.5b", "deepseek-coder-33b", "internlm2-20b",
                 "pixtral-12b"):
        api = get_model(reduced_config(REGISTRY[arch]), "cpu")
        assert api.device == torch.device("cpu")
