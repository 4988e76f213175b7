"""Shared whole-model checks of the port's LM families against the
reference, on the CPU (``tests/test_torch_lm_{ssm,moe,mla_encdec}.py``).

Each case carries the reference's init of a reduced float32 config into
the port (``models/convert.py``) and feeds both the same NumPy batch:
hidden states, logits and loss within rtol/atol 1e-5; every gradient
leaf against ``jax.grad`` within rtol 1e-4 / atol 1e-6 (zamba2's shared
block is one leaf, its gradient summed over its uses in both packages;
zamba2 at atol 2e-6: its embedding gradient, 1.46 at its largest, sums
the backward of seven blocks, and the reference's own jitted and
op-by-op gradients already differ there by 0.78 of the 1e-6 bound);
``remat`` full == none bitwise; decode against the reference's decode
within 1e-4 and against the port's own train path within 2e-2 at each
position (the reference test's tolerance); params both ways bitwise, in
float32 and bfloat16 (the float32 router, ``a_log``, ``dt_bias`` and
``d_skip`` inside a bfloat16 model included); and every leaf's dtype
after one train step equal to the reference's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.models import encdec as jencdec
from repro.models import transformer as jtf
from repro.models.registry import get_model as jget_model
from repro.models.registry import reduced_config as jreduced
from repro.runtime.compat import make_mesh
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import REGISTRY
from repro_torch.models import encdec, transformer
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.registry import get_model
from repro_torch.models.tree import tree_items, tree_leaves, tree_unflatten
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
GRAD_ATOL = {"zamba2-1.2b": 2e-6}         # see the module docstring
DECODE_REF = dict(rtol=1e-4, atol=1e-4)
DECODE_TRAIN = dict(rtol=2e-2, atol=2e-2)


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
    of ``reduced_config`` carried into the port."""
    jcfg = dataclasses.replace(jreduced(JREGISTRY[arch], **over),
                               param_dtype=dtype)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(seed))
    cfg = port_cfg(jcfg)
    return jcfg, jp, cfg, params_from_reference(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


def make_case_batch(cfg, b=2, s=40, s_enc=24, seed=0):
    """Tokens (or frames + tokens) with a partly masked loss."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.int32)
    mask[:, : s // 3] = 0
    out = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "mask": mask}
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(size=(b, s_enc, cfg.d_model)
                                   ).astype(np.float32)
        out["tokens"] = toks
    else:
        out["inputs"] = toks
    return out


def jax_batch(batch, jcfg):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "frames" in out:
        out["frames"] = out["frames"].astype(jcfg.dtype)
    return out


def port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def jax_hidden(jp, jb, jcfg):
    if jcfg.is_encoder_decoder:
        enc = jencdec.encode(jp, jb["frames"], jcfg)
        h = jencdec._decode_blocks(
            jp, jnp.take(jp["embed"]["table"], jb["tokens"], axis=0), enc,
            jcfg)
        return h, jp["head"]["w"]
    return jtf.forward_train(jp, jb["inputs"], jcfg), jtf._head_w(jp, jcfg)


def port_hidden(p, b, cfg):
    if cfg.is_encoder_decoder:
        enc = encdec.encode(p, b["frames"], cfg)
        return encdec.decode_hidden(p, b["tokens"], enc, cfg), p["head"]["w"]
    return transformer.forward_train(p, b["inputs"], cfg), \
        transformer.head_w(p, cfg)


def build_case(arch, **over):
    """Everything the whole-model checks compare against, computed once."""
    jcfg, jp, cfg, p = carried(arch, **over)
    batch = make_case_batch(cfg)
    jb = jax_batch(batch, jcfg)
    jh, jhead = jax.jit(lambda prm, bt: jax_hidden(prm, bt, jcfg))(jp, jb)
    japi = jget_model(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss))(jp, jb)
    return dict(arch=arch, jcfg=jcfg, jp=jp, cfg=cfg, p=p, batch=batch,
                jh=jh, jhead=jhead, jloss=jloss, jgrads=jgrads)


def check_forward(c):
    cfg, p, b = c["cfg"], c["p"], port_batch(c["batch"])
    with torch.no_grad():
        h, head = port_hidden(p, b, cfg)
        loss = get_model(cfg, "cpu").loss(p, b)
    close(h, c["jh"], **F32)
    close(h @ head, c["jh"] @ c["jhead"], **F32)
    close(loss, c["jloss"], **F32)


def port_grads(p, batch, cfg):
    leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
    params = tree_unflatten(p, leaves)
    loss = get_model(cfg, "cpu").loss(params, port_batch(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g
                  for x, g in zip(leaves, grads)], params


def check_grads(c):
    _, grads, params = port_grads(c["p"], c["batch"], c["cfg"])
    want = dict(tree_items(jax.tree.map(np.asarray, c["jgrads"])))
    names = [n for n, _ in tree_items(params)]
    assert names == sorted(want) and len(names) == len(grads)
    tol = dict(GRAD, atol=GRAD_ATOL.get(c["arch"], GRAD["atol"]))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **tol)


def check_remat(c):
    """Checkpointed blocks recompute what the plain forward computes."""
    out = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(c["cfg"], remat=remat)
        loss, grads, _ = port_grads(c["p"], c["batch"], cfg)
        out[remat] = [loss] + grads
    for a, b in zip(out["full"], out["none"]):
        assert torch.equal(a, b)


def check_decode(arch, B=2, T=9, s_enc=12):
    """Token by token from an empty cache: the port's logits equal the
    reference's decode (same cache contents) and the port's own train
    path at each position (padded vocab columns masked in both). For the
    encoder-decoder the cross cache is filled from the frames in both
    packages (the reference has no step that fills it: the port's fill
    is carried over), and the train path decodes against those frames."""
    jcfg, jp, cfg, p = carried(arch, seed=1, vocab_size=64,
                               vocab_pad_multiple=64)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    japi, api = jget_model(jcfg), get_model(cfg, "cpu")
    if cfg.is_encoder_decoder:
        frames = t(rng.normal(size=(B, s_enc, cfg.d_model)
                              ).astype(np.float32))
        cache = api.make_cache(B, T + 1, enc_len=s_enc)
        with torch.no_grad():
            enc = encdec.fill_cross_cache(p, cache, frames, cfg)
            h = encdec.decode_hidden(p, t(toks), enc, cfg)
        jcache = japi.make_cache(B, T + 1, enc_len=s_enc)
        jcache = dict(jcache, x_k=jnp.asarray(cache["x_k"].numpy()),
                      x_v=jnp.asarray(cache["x_v"].numpy()))
        head = p["head"]["w"]
    else:
        with torch.no_grad():
            h = transformer.forward_train(p, t(toks), cfg)
        cache, jcache = api.make_cache(B, T + 1), japi.make_cache(B, T + 1)
        head = transformer.head_w(p, cfg)
    train_logits = (h @ head).numpy()
    jdec = jax.jit(japi.decode)
    V = cfg.vocab_size
    for i in range(T):
        want, jcache = jdec(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, cache = api.decode(p, cache, t(toks[:, i:i + 1]))
        close(got, want, **DECODE_REF)
        np.testing.assert_allclose(got[:, :V].numpy(), train_logits[:, i, :V],
                                   err_msg=f"{arch} diverged at {i}",
                                   **DECODE_TRAIN)
        assert bool((got[:, V:] == -1e30).all())
    assert int(cache["length"]) == int(jcache["length"]) == T
    for name, x in cache.items():               # caches hold the same rows
        if name != "length":
            close(x, jcache[name], **DECODE_REF)


def check_params_both_ways(arch):
    """Params cross both ways bit for bit, float32 and bfloat16; the
    port's own init has the reference's paths, shapes and dtypes."""
    for dtype in ("float32", "bfloat16"):
        jcfg, jp, cfg, p = carried(arch, dtype=dtype)
        want = jax.tree.map(np.asarray, jp)
        back = params_to_reference(p)
        assert [n for n, _ in tree_items(back)] == \
            [n for n, _ in tree_items(want)]
        for (name, a), (_, b) in zip(tree_items(back), tree_items(want)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
        fresh = get_model(cfg, "cpu").init(0)
        assert [(n, tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for n, x in tree_items(fresh)] == \
            [(n, a.shape, str(a.dtype)) for n, a in tree_items(want)]


def check_dtypes_after_step(arch):
    """One train step in bfloat16 in both packages: every param, master,
    m and v leaf has the reference's dtype (AdamW casts the float32
    router, ``a_log``, ``dt_bias`` and ``d_skip`` to bfloat16, as the
    reference's does)."""
    jcfg, jp, cfg, p = carried(arch, dtype="bfloat16")
    batch = make_case_batch(cfg, b=2, s=16, s_enc=16)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep, _ = jmake_train_step(jget_model(jcfg), make_mesh(
        (1, 1), ("data", "model")), n_micro=1,
        opt_cfg=jopt.AdamWConfig(**ocfg))
    jstate = {"params": jp, "opt": jopt.init_opt_state(jp),
              "step": jnp.zeros((), jnp.int32)}
    jstate, _ = jax.jit(jstep)(jstate, jax_batch(batch, jcfg))
    step, _ = make_train_step(get_model(cfg, "cpu"),
                              opt_cfg=opt.AdamWConfig(**ocfg))
    state = {"params": p, "opt": opt.init_opt_state(p),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = step(state, port_batch(batch))
    assert np.isfinite(float(m["loss"]))
    f32 = {n for n, x in tree_items(p) if x.dtype == torch.float32}
    assert bool(f32) == bool(cfg.n_experts or cfg.family in ("ssm",
                                                             "hybrid"))
    for part, got, want in (("params", state["params"], jstate["params"]),
                            ("master", state["opt"]["master"],
                             jstate["opt"]["master"]),
                            ("m", state["opt"]["m"], jstate["opt"]["m"]),
                            ("v", state["opt"]["v"], jstate["opt"]["v"])):
        want = dict(tree_items(jax.tree.map(np.asarray, want)))
        for name, x in tree_items(got):
            assert str(x.dtype).removeprefix("torch.") == \
                str(want[name].dtype), (part, name)
    for name in f32:
        assert dict(tree_items(state["params"]))[name].dtype == \
            torch.bfloat16, name
