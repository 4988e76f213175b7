"""Sharded LM cases for the port's tests, on the CPU: the gloo-world
scenarios that ``tests/_torch_dist.py::run_world`` runs as
``"_torch_lm_dist:<function>"``, the one-device runs they are held to,
and the reference's sharded step on forged devices (``REFERENCE``, run
as a script in a subprocess).

Every case is a reduced float32 config (two layers, d_model 64) trained
two steps from the same weights (``save_weights``: the port's one-device
init, as the reference's tree of arrays) on the same batches
(``make_batch``). This module imports ``torch`` and ``repro_torch``
only, never JAX.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

LR = dict(lr=3e-3, warmup_steps=1, total_steps=10)
STEPS = 2

# name: arch, config overrides, mesh, policy, rs_per_micro, seq, batch
CASES = {
    "qwen_tp_2x2": ("qwen1.5-0.5b", {}, (2, 2), "tp", True, 32, 8),
    "qwen_tp_2x2_rs_once": ("qwen1.5-0.5b", {}, (2, 2), "tp", False, 32, 8),
    "qwen_tp_1x4": ("qwen1.5-0.5b", {}, (1, 4), "tp", True, 32, 8),
    "qwen_dp_4x1": ("qwen1.5-0.5b", {}, (4, 1), "dp", True, 32, 8),
    "qwen_dp_4x1_rs_once": ("qwen1.5-0.5b", {}, (4, 1), "dp", False, 32, 8),
    # a2a over model (seq 32 divides 2), lossless
    "moe_tp_2x2": ("deepseek-moe-16b", dict(capacity_factor=64.0), (2, 2),
                   "tp", True, 32, 8),
    # a2a over every axis (4 rows a micro-batch on 4 ranks), lossless
    "moe_ep_2x2": ("deepseek-moe-16b", dict(capacity_factor=64.0), (2, 2),
                   "ep", True, 32, 8),
    # the default capacity: tokens overflow cap_s and cap2
    "moe_tp_2x2_overflow": ("deepseek-moe-16b", {}, (2, 2), "tp", True, 32,
                            8),
    # six experts padded to eight (two dead); seq 33 does not divide the
    # model axis: replicated-activation expert parallelism
    "granite_tp_1x2": ("granite-moe-3b-a800m",
                       dict(n_experts=6, n_kv_heads=2), (1, 2), "tp", True,
                       33, 8),
}
# AdamW's eps a case: at the default 1e-8 a weight whose gradient sits at
# the rounding floor moves by ±lr on its sign, which either package may
# take; in granite's second step such a move flips a near-tied route,
# and the loss moves by 2e-4. eps = 1e-3 keeps the update smooth there.
SMOOTH = {"granite_tp_1x2": 1e-3}
WORLD4 = [k for k, c in CASES.items() if np.prod(c[2]) == 4]
WORLD2 = [k for k, c in CASES.items() if np.prod(c[2]) == 2]
N_MICRO = 2

# the other families tensor-parallel, and the fsdp policy
# (tests/test_torch_lm_families_sharded.py), in the layout of CASES
FAMILY_CASES = {
    "mamba_tp_2x2": ("mamba2-370m", {}, (2, 2), "tp", True, 32, 8),
    # two groups of two SSM layers, the shared block after each, and one
    # more layer: the shared block's gradient sums its two uses
    "zamba_tp_2x2": ("zamba2-1.2b", dict(n_layers=5), (2, 2), "tp", True,
                     32, 8),
    "mla_tp_2x2": ("minicpm3-4b", {}, (2, 2), "tp", True, 32, 8),
    "whisper_tp_2x2": ("whisper-base", {}, (2, 2), "tp", True, 32, 8),
    "qwen_fsdp_2x2": ("qwen1.5-0.5b", {}, (2, 2), "fsdp", True, 32, 8),
    # 33 frames: an encoder length that does not divide the model axis
    "whisper_tp_1x2": ("whisper-base", {}, (1, 2), "tp", True, 33, 8),
    "zamba_fsdp_1x2": ("zamba2-1.2b", dict(n_layers=5), (1, 2), "fsdp",
                       True, 32, 8),
}
# eps 1e-3 for the families but qwen (SMOOTH's reason): their sharded
# gradients are the one-device ones within 1e-6 of each leaf's largest,
# but at eps 1e-8 the first update of a weight whose gradient is that
# small is its gradient's sign, and 1-14% of the masters moved by up to
# 0.2·lr from either side
SMOOTH.update({k: 1e-3 for k in FAMILY_CASES if not k.startswith("qwen")})
FAMILY4 = [k for k, c in FAMILY_CASES.items() if np.prod(c[2]) == 4]
FAMILY2 = [k for k, c in FAMILY_CASES.items() if np.prod(c[2]) == 2]

# heads and experts that do not divide the model axis, and the dp and
# fsdp policies' MoE on it (tests/test_torch_lm_sharded_heads.py), in the
# layout of CASES
HEADS_CASES = {
    # 6 query heads on 4: a head's columns lie on two ranks; seq 32
    # divides the axis: sequence-parallel attention
    "heads6_tp_1x4": ("qwen1.5-0.5b", dict(n_heads=6, n_kv_heads=6), (1, 4),
                      "tp", True, 32, 8),
    # seq 33 does not: every rank runs the whole attention
    "heads6_tp_1x4_seq33": ("qwen1.5-0.5b", dict(n_heads=6, n_kv_heads=6),
                            (1, 4), "tp", True, 33, 8),
    # 4 query heads divide 4, 2 KV heads do not: a rank's one query head
    # reads its KV head, half a group
    "kv2_tp_1x4": ("qwen1.5-0.5b", dict(n_kv_heads=2), (1, 4), "tp", True,
                   32, 8),
    "mla6_tp_1x4": ("minicpm3-4b", dict(n_heads=6, n_kv_heads=6), (1, 4),
                    "tp", True, 32, 8),
    # the dp and fsdp policies' MoE on (2, 2): the all-to-all route on the
    # data shard's rows (seq 32), and replicated-activation (seq 33); at
    # capacity factor 4 no bucket can overflow (cap_s ≥ t·k needs cf ≥ P
    # = 2, cap2 ≥ P·cap_s needs cf ≥ the rank's 4 experts)
    "moe_dp_2x2": ("deepseek-moe-16b", dict(capacity_factor=4.0), (2, 2),
                   "dp", True, 32, 8),
    "moe_fsdp_2x2": ("deepseek-moe-16b", dict(capacity_factor=4.0), (2, 2),
                     "fsdp", True, 32, 8),
    "moe_dp_2x2_seq33": ("deepseek-moe-16b", dict(capacity_factor=4.0),
                         (2, 2), "dp", True, 33, 8),
    # 64 expert stacks on a model axis of 3: the dispatch of the global
    # batch; under dp on 6 rows of 768 (a micro-batch's 4,608
    # assignments past 4,096) its capacity drops tokens, and the rows are
    # gathered to keep the global order
    "moe64_tp_1x3": ("deepseek-moe-16b", dict(n_experts=64,
                                              capacity_factor=64.0),
                     (1, 3), "tp", True, 32, 6),
    "moe64_dp_1x3": ("deepseek-moe-16b", dict(n_experts=64), (1, 3), "dp",
                     True, 768, 6),
    # the dp policy's MoE at the default capacity: the all-to-all route
    # drops tokens by the rank's own capacity, as the reference's
    # shard_map does, so it is held to the reference's sharded step (the
    # one-device step drops others)
    "moe_dp_2x2_drop": ("deepseek-moe-16b", {}, (2, 2), "dp", True, 32, 8),
}
# at eps 1e-8, 169 of this case's 177,472 masters end more than 1e-6 from
# the one-device step's (0.95 per mille, against the tests' bound of 1):
# SMOOTH's reason, too near the bound to hold on another CPU. The other
# cases at 1e-8: 0-0.43 per mille (heads6 0.36, heads6 seq 33 0.43, kv2
# 0.33, mla6 0.10, moe dp and fsdp 0.03, moe64 tp 0, dp 0.003)
SMOOTH["moe_dp_2x2_seq33"] = 1e-3
HEADS4 = [k for k, c in HEADS_CASES.items() if np.prod(c[2]) == 4]
HEADS3 = [k for k, c in HEADS_CASES.items() if np.prod(c[2]) == 3]
ALL_CASES = {**CASES, **FAMILY_CASES, **HEADS_CASES}


def config(name: str):
    """The port's config of a case."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models.registry import reduced_config
    arch, over = ALL_CASES[name][:2]
    return dataclasses.replace(
        reduced_config(REGISTRY[arch], **{"n_layers": 2, "d_model": 64,
                                          **over}),
        param_dtype="float32")


def save_weights(name: str, path: Path) -> None:
    """The port's one-device init (seed 0) as an .npz of the reference's
    tree of arrays, ``/``-joined paths as keys."""
    from repro_torch.models.convert import params_to_reference
    from repro_torch.models.registry import get_model
    from repro_torch.models.tree import tree_items
    params = get_model(config(name), "cpu").init(0)
    np.savez(path, **dict(tree_items(params_to_reference(params))))


def load_tree(path) -> dict:
    from repro_torch.models.tree import tree_from_items
    with np.load(path) as z:
        return tree_from_items((k, z[k]) for k in z.files)


def adamw(name: str) -> dict:
    """The AdamW config of a case, as keyword arguments."""
    return {**LR, **({"eps": SMOOTH[name]} if name in SMOOTH else {})}


def batches(cfg, seq: int, batch: int) -> list:
    from repro_torch.data.synthetic import make_batch
    return [make_batch(cfg, seq, batch, "train", step=i)
            for i in range(STEPS)]


def _run(name: str, weights: str, mesh=None) -> dict:
    """Two steps of a case: on ``mesh`` (this rank's part) or one
    device. Returns every step's loss and grad norm, and the final
    master on the one-device layout (gathered: collective)."""
    import torch
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.registry import get_model
    from repro_torch.models.tree import tree_items
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import full_state, make_train_step
    _, _, _, policy, rs, seq, batch = ALL_CASES[name]
    cfg = config(name)
    api = get_model(cfg, "cpu")
    params = params_from_reference(load_tree(weights), cfg, "cpu",
                                   mesh=mesh, policy=policy)
    step, init = make_train_step(api, mesh, n_micro=N_MICRO,
                                 opt_cfg=AdamWConfig(**adamw(name)),
                                 policy=policy,
                                 rs_per_micro=rs)
    state = init(params=params)
    out = {"loss": [], "grad_norm": []}
    for b in batches(cfg, seq, batch):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    full = full_state(state, api, mesh, policy)
    out["master"] = {p: t.numpy() for p, t in
                     tree_items(full["opt"]["master"])}
    if mesh is not None:
        out["traffic"] = dict(mesh.traffic)
        out["shapes"] = {p: tuple(t.shape)
                         for p, t in tree_items(state["params"])}
    return out


def one_device(name: str, weights: str) -> dict:
    return _run(name, weights)


# train_lm on a (2, 2) mesh: reduced qwen1.5-0.5b (bfloat16), a
# checkpoint at step 3
LAUNCH = dict(steps=5, seq_len=16, global_batch=4, log_every=1,
              checkpoint_every=3)


def backward_in_a_thread(name: str, weights: str, mesh) -> bool:
    """The loss of a case on ``mesh`` differentiated in this thread and in
    another one, as autograd's device thread runs a CUDA backward (it
    does not see this thread's rules): the same gradients, bitwise."""
    import threading
    import torch
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.registry import get_model
    from repro_torch.models.tree import tree_leaves
    from repro_torch.runtime.sharding import LogicalRules, use_rules
    _, _, _, policy, _, seq, batch = CASES[name]
    cfg = config(name)
    api = get_model(cfg, "cpu")
    params = params_from_reference(load_tree(weights), cfg, "cpu",
                                   mesh=mesh, policy=policy)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, seq, batch)[0]
         .items()}
    grads = []
    for where in ("here", "thread"):
        with use_rules(LogicalRules(mesh, policy=policy, batch=())):
            loss = api.loss(params, b)
        if where == "here":
            grads.append(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))
        else:
            t = threading.Thread(target=lambda: grads.append(
                torch.autograd.grad(loss, leaves, allow_unused=True)))
            t.start()
            t.join(60)
    return len(grads) == 2 and all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(*grads))


def sharded(rank: int, world: int, names: list, weights_dir: str,
            ckpt: str | None = None) -> dict:
    """A gloo-world scenario: every case of ``names`` on its mesh; rank 0
    keeps the masters, every rank its losses and norms. With ``ckpt``,
    then ``train_lm`` on a (2, 2) mesh writing its checkpoints there
    (every rank's log lines and losses kept)."""
    from repro_torch.runtime.sharding import ProcessMesh
    out = {}
    for name in names:
        shape = ALL_CASES[name][2]
        mesh = ProcessMesh(shape, ("data", "model"))
        got = _run(name, str(Path(weights_dir) / f"{name}.npz"), mesh)
        if rank:
            got.pop("master")
        out[name] = got
    if world == 2:
        name = names[0]
        out["backward_in_a_thread"] = backward_in_a_thread(
            name, str(Path(weights_dir) / f"{name}.npz"),
            ProcessMesh(CASES[name][2], ("data", "model")))
    if ckpt is not None:
        from repro_torch.launch.train import train_lm
        lines: list = []
        hist = train_lm("qwen1.5-0.5b", **LAUNCH, device="cpu",
                        checkpoint_dir=ckpt,
                        mesh=ProcessMesh((2, 2), ("data", "model")),
                        log_fn=lines.append)
        out["train_lm"] = {"loss": hist["loss"], "step": hist["step"],
                           "lines": lines}
    return out


# the reference's sharded step on forged CPU devices (runtime/compat's
# Auto-axis mesh), as a script: argv[1] a JSON list of [name, config
# dict, AdamW dict, mesh, policy, rs_per_micro, seq, batch], argv[2] the
# weights' directory, argv[3] the output .npz
REFERENCE = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import REGISTRY
from repro.data.synthetic import make_batch
from repro.models.config import ModelConfig
from repro.models.registry import get_model
from repro.runtime.compat import make_mesh
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.train_step import make_train_step
cases = json.loads(sys.argv[1])
out = {}
for name, cfg_d, opt_d, mesh, policy, rs, seq, batch in cases:
    cfg = ModelConfig(**cfg_d)
    api = get_model(cfg)
    with np.load(os.path.join(sys.argv[2], name + ".npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = {}
    for k, v in flat.items():
        node = tree
        *par, last = k.split("/")
        for p in par:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    m = make_mesh(tuple(mesh), ("data", "model"),
                  devices=jax.devices()[:int(np.prod(mesh))])
    step, _ = make_train_step(api, m, n_micro=%(n_micro)d,
                              opt_cfg=AdamWConfig(**opt_d), policy=policy,
                              rs_per_micro=rs)
    state = {"params": tree, "opt": init_opt_state(tree),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(step)
    for i in range(%(steps)d):
        b = make_batch(cfg, seq, batch, "train", step=i)
        state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out[f"{name}|loss|{i}"] = np.asarray(met["loss"])
        out[f"{name}|grad_norm|{i}"] = np.asarray(met["grad_norm"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            state["opt"]["master"]):
        key = "/".join(str(p.key) for p in path)
        out[f"{name}|master|{key}"] = np.asarray(leaf)
np.savez(sys.argv[3], **out)
''' % {"n_micro": N_MICRO, "steps": STEPS}


def reference_args(names: list) -> str:
    """argv[1] of ``REFERENCE``: the cases with their configs as dicts
    (the reference's ModelConfig takes the port's fields)."""
    return json.dumps([[n, dataclasses.asdict(config(n)), adamw(n),
                        list(ALL_CASES[n][2]), *ALL_CASES[n][3:]]
                       for n in names])


def read_reference(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for k in z.files:
            name, what, rest = k.split("|", 2)
            case = out.setdefault(name, {"loss": [], "grad_norm": [],
                                         "master": {}})
            if what == "master":
                case["master"][rest] = z[k]
            else:
                case[what].append(float(z[k]))
    return out


# -- sharded decode and prefill ----------------------------------------------

# name: arch, config overrides, mesh, batch, cache slots, decoded tokens,
# encoder length (whisper), prefill length (whisper: the frames, as its
# prefill is the encoder's, in both packages). Twelve tokens on a cache of
# 16 slots split over model cross from the first rank's sequence block
# into the next (and past every slot on a split of 4: the last writes
# clamp to slot 15, as dynamic_update_slice clamps)
SERVE = {
    "qwen_serve_2x2": ("qwen1.5-0.5b", {}, (2, 2), 4, 16, 12, None, 8),
    # batch 1 does not divide the data axis: the KV heads lie over it
    "qwen_serve_2x2_b1": ("qwen1.5-0.5b", {}, (2, 2), 1, 16, 12, None, 8),
    "qwen_serve_1x4": ("qwen1.5-0.5b", {}, (1, 4), 2, 8, 10, None, 8),
    # decode's single position takes the replicated-activation route
    # capacity factor 64: the prefill's all-to-all route drops no token
    "moe_serve_2x2": ("deepseek-moe-16b", dict(capacity_factor=64.0), (2, 2),
                      4, 16, 12, None, 8),
    "mla_serve_2x2": ("minicpm3-4b", {}, (2, 2), 4, 16, 12, None, 8),
    "ssm_serve_2x2": ("mamba2-370m", {}, (2, 2), 4, 16, 12, None, 8),
    # the shared block's two KV slots, batch 1: heads over data
    "hybrid_serve_2x2_b1": ("zamba2-1.2b", {}, (2, 2), 1, 16, 12, None, 8),
    # 33 frames do not divide the model axis: the cross cache stays whole
    "whisper_serve_2x2": ("whisper-base", {}, (2, 2), 4, 16, 12, 33, 33),
    "whisper_serve_1x2": ("whisper-base", {}, (1, 2), 2, 16, 12, 32, 32),
    "qwen_serve_2x1": ("qwen1.5-0.5b", {}, (2, 1), 4, 16, 12, None, 8),
    "mla_serve_1x2": ("minicpm3-4b", {}, (1, 2), 2, 16, 12, None, 8),
    "hybrid_serve_1x2": ("zamba2-1.2b", {}, (1, 2), 2, 16, 12, None, 8),
}
# heads that do not divide the model axis (tests/test_torch_lm_sharded_
# heads.py): decode gathers q, k and v by columns; prefill runs the
# sequence-parallel layout (8 positions on 4) or the whole one (6)
HEADS_SERVE = {
    "heads6_serve_1x4": ("qwen1.5-0.5b", dict(n_heads=6, n_kv_heads=6),
                         (1, 4), 2, 16, 10, None, 8),
    "kv2_serve_1x4": ("qwen1.5-0.5b", dict(n_kv_heads=2), (1, 4), 2, 16, 10,
                      None, 8),
    "mla6_serve_1x4": ("minicpm3-4b", dict(n_heads=6, n_kv_heads=6), (1, 4),
                       2, 16, 10, None, 6),
}
SERVE4 = [k for k, c in SERVE.items() if np.prod(c[2]) == 4]
SERVE2 = [k for k, c in SERVE.items() if np.prod(c[2]) == 2]


def serve_case(name: str) -> tuple:
    return SERVE[name] if name in SERVE else HEADS_SERVE[name]


def serve_config(name: str):
    from repro_torch.configs import REGISTRY
    from repro_torch.models.registry import reduced_config
    arch, over = serve_case(name)[:2]
    return dataclasses.replace(
        reduced_config(REGISTRY[arch], n_layers=2, d_model=64, **over)
        if arch != "zamba2-1.2b" else
        reduced_config(REGISTRY[arch], d_model=64, **over),
        param_dtype="float32")


def save_serve_weights(name: str, path: Path) -> None:
    from repro_torch.models.convert import params_to_reference
    from repro_torch.models.registry import get_model
    from repro_torch.models.tree import tree_items
    params = get_model(serve_config(name), "cpu").init(0)
    np.savez(path, **dict(tree_items(params_to_reference(params))))


def serve_inputs(name: str) -> dict:
    """A case's decode tokens (n, B, 1), prefill inputs (B, S) and, for
    the encoder-decoder, frames (B, enc_len, d): NumPy, from a seed."""
    _, _, _, batch, _, n_tok, enc_len, s_pre = serve_case(name)
    cfg = serve_config(name)
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (n_tok, batch, 1)
                                  ).astype(np.int32)}
    if enc_len:
        out["frames"] = rng.normal(size=(batch, enc_len, cfg.d_model)
                                   ).astype(np.float32)
        out["inputs"] = out["frames"]
    else:
        out["inputs"] = rng.integers(0, cfg.vocab_size, (batch, s_pre)
                                     ).astype(np.int32)
    return out


def _serve(name: str, weights: str, mesh=None) -> dict:
    """A case's decode (every step's logits, whole), its prefill and, for
    the encoder-decoder, a decode after ``fill_cross_cache``: on
    ``mesh`` (this rank's blocks, the logits gathered: collective) or on
    one device."""
    import torch
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.registry import get_model, make_rank_cache
    from repro_torch.models.tree import tree_items
    from repro_torch.runtime.sharding import batch_axes, gather_leaf
    from repro_torch.train.serve_step import (logits_spec, make_fill_step,
                                              make_prefill_step,
                                              make_serve_step,
                                              serve_state_shardings)
    _, _, _, batch, max_len, _, enc_len, _ = serve_case(name)
    cfg = serve_config(name)
    api = get_model(cfg, "cpu")
    params = params_from_reference(load_tree(weights), cfg, "cpu",
                                   mesh=mesh, serving=True)
    ins = {k: torch.from_numpy(v) for k, v in serve_inputs(name).items()}
    specs = None
    if mesh is not None:
        specs = serve_state_shardings(api, mesh, batch, max_len,
                                      enc_len)[3]

    def fresh():
        if mesh is None:
            return (api.make_cache(batch, max_len, enc_len=enc_len)
                    if enc_len else api.make_cache(batch, max_len))
        return make_rank_cache(api, mesh, specs, batch, max_len, enc_len)

    def whole(logits):
        if mesh is None:
            return logits.numpy()
        if logits.ndim == 3:               # the encoder's output: rows
            e = batch_axes(mesh) if logits.shape[0] < batch else None
            return gather_leaf(logits, (e,), mesh).numpy()
        return gather_leaf(logits, logits_spec(mesh, batch,
                                               cfg.padded_vocab),
                           mesh).numpy()

    step = make_serve_step(api, mesh, specs)

    def decode(cache):
        out = []
        for tok in ins["tokens"]:
            logits, cache = step(params, cache, tok)
            out.append(whole(logits))
        return np.stack(out)

    blocks = fresh()
    out = {"decode": decode(blocks),
           "prefill": whole(make_prefill_step(api, mesh)(params,
                                                         ins["inputs"]))}
    if enc_len:
        cache = fresh()
        make_fill_step(api, mesh, specs)(params, cache, ins["frames"])
        out["decode_filled"] = decode(cache)
    if mesh is not None:
        out["traffic"] = dict(mesh.traffic)
        out["cache"] = {p: tuple(t.shape) for p, t in tree_items(blocks)}
    return out


def serve_one_device(name: str, weights: str) -> dict:
    return _serve(name, weights)


def serve(rank: int, world: int, names: list, weights_dir: str) -> dict:
    """A gloo-world scenario: every serving case of ``names`` on its
    mesh (every rank returns the whole logits)."""
    from repro_torch.runtime.sharding import ProcessMesh
    return {name: _serve(name, str(Path(weights_dir) / f"{name}.npz"),
                         ProcessMesh(serve_case(name)[2], ("data", "model")))
            for name in names}


# the reference's sharded decode and prefill on forged CPU devices: its
# make_serve_step and make_prefill_step, jitted, on params and a cache
# placed by serve_state_shardings. argv[1] a JSON list of [name, config
# dict, mesh, batch, max_len, enc_len], argv[2] the weights' and inputs'
# directory, argv[3] the output .npz
REFERENCE_SERVE = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.models.config import ModelConfig
from repro.models.registry import get_model
from repro.runtime.compat import make_mesh
from repro.train.serve_step import (make_prefill_step, make_serve_step,
                                    serve_state_shardings)
out = {}
for name, cfg_d, mesh, batch, max_len, enc_len in json.loads(sys.argv[1]):
    cfg = ModelConfig(**cfg_d)
    api = get_model(cfg)
    def tree_of(path):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        tree = {}
        for k, v in flat.items():
            node = tree
            *par, last = k.split("/")
            for p in par:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(v)
        return tree
    tree = tree_of(os.path.join(sys.argv[2], name + ".npz"))
    with np.load(os.path.join(sys.argv[2], name + "-inputs.npz")) as z:
        ins = {k: z[k] for k in z.files}
    m = make_mesh(tuple(mesh), ("data", "model"),
                  devices=jax.devices()[:int(np.prod(mesh))])
    _, _, p_shard, c_shard = serve_state_shardings(api, m, batch, max_len,
                                                   enc_len)
    params = jax.device_put(tree, p_shard)
    cache = (api.make_cache(batch, max_len, enc_len=enc_len) if enc_len
             else api.make_cache(batch, max_len))
    cache = jax.device_put(cache, c_shard)
    step = jax.jit(make_serve_step(api, m))
    logits = []
    for tok in ins["tokens"]:
        lg, cache = step(params, cache, jnp.asarray(tok))
        logits.append(np.asarray(lg))
    out[name + "|decode"] = np.stack(logits)
    if len(ins["tokens"]) > max_len:      # past the last slot: one device
        cache, step1, logits = api.make_cache(batch, max_len), \
            jax.jit(api.decode), []
        for tok in ins["tokens"]:
            lg, cache = step1(tree, cache, jnp.asarray(tok))
            logits.append(np.asarray(lg))
        out[name + "|decode_one"] = np.stack(logits)
    out[name + "|prefill"] = np.asarray(jax.jit(make_prefill_step(api, m))(
        params, jnp.asarray(ins["inputs"])))
np.savez(sys.argv[3], **out)
'''


def reference_serve_args(names: list, d: Path) -> str:
    """argv[1] of ``REFERENCE_SERVE``; writes each case's inputs to
    ``d``."""
    for n in names:
        np.savez(d / f"{n}-inputs.npz", **serve_inputs(n))
    return json.dumps([[n, dataclasses.asdict(serve_config(n)),
                        list(serve_case(n)[2]), *[serve_case(n)[i]
                                                  for i in (3, 4, 6)]]
                       for n in names])


def read_reference_serve(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for k in z.files:
            name, what = k.split("|")
            out.setdefault(name, {})[what] = z[k]
    return out


# train_lm on (1, N) for the four families (reduced, bfloat16), held to
# the one-device train_lm on the same seed and batches
FAMILY_ARCHS = ("mamba2-370m", "zamba2-1.2b", "minicpm3-4b", "whisper-base")
FAMILY_LAUNCH = dict(steps=2, seq_len=16, global_batch=4, log_every=1)


def families(rank: int, world: int, names: list, weights_dir: str) -> dict:
    """A gloo-world scenario: every train case of ``names`` on its mesh
    (rank 0 keeps the masters); in a world of 2, also ``train_lm`` of
    each family on the (1, 2) mesh it picks by itself."""
    from repro_torch.runtime.sharding import ProcessMesh
    out = {}
    for name in names:
        mesh = ProcessMesh(FAMILY_CASES[name][2], ("data", "model"))
        got = _run(name, str(Path(weights_dir) / f"{name}.npz"), mesh)
        if rank:
            got.pop("master")
        out[name] = got
    if world == 2:
        from repro_torch.launch.train import train_lm
        for arch in FAMILY_ARCHS:
            hist = train_lm(arch, **FAMILY_LAUNCH, device="cpu",
                            log_fn=lambda _line: None)
            out[f"train_lm/{arch}"] = hist["loss"]
    return out


def heads(rank: int, world: int, names: list, serve_names: list,
          weights_dir: str) -> dict:
    """A gloo-world scenario: every train case of ``names`` on its mesh
    (rank 0 keeps the masters) and every serving case of
    ``serve_names`` (every rank returns the whole logits)."""
    from repro_torch.runtime.sharding import ProcessMesh
    out = {}
    for name in names:
        mesh = ProcessMesh(HEADS_CASES[name][2], ("data", "model"))
        got = _run(name, str(Path(weights_dir) / f"{name}.npz"), mesh)
        if rank:
            got.pop("master")
        out[name] = got
    out.update(serve(rank, world, serve_names, weights_dir))
    return out


def vocab_loss(rank: int, world: int, path: str) -> dict:
    """A gloo-world scenario: ``cross_entropy_chunked`` of the arrays in
    ``path`` (h, w, y, m) with the head split over a (1, world) mesh's
    ``model`` (the vocab-parallel loss); the loss and the whole
    gradients."""
    import torch
    from repro_torch.models import layers
    from repro_torch.runtime.sharding import (LogicalRules, ProcessMesh,
                                              gather_leaf, use_rules)
    mesh = ProcessMesh((1, world), ("data", "model"))
    with np.load(path) as z:
        h, w, y, m = (torch.from_numpy(z[k]) for k in ("h", "w", "y", "m"))
    n = w.shape[1] // world
    hp = h.clone().requires_grad_()
    wp = w[:, rank * n:(rank + 1) * n].clone().requires_grad_()
    with use_rules(LogicalRules(mesh, batch=())):
        loss = layers.cross_entropy_chunked(hp, wp, y, m, chunk=16,
                                            vocab=w.shape[1])
    gh, gw = torch.autograd.grad(loss, (hp, wp))
    return {"loss": float(loss), "gh": gh.numpy(),
            "gw": gather_leaf(gw, (None, "model"), mesh).numpy()}
