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


def config(name: str):
    """The port's config of a case."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models.registry import reduced_config
    arch, over = CASES[name][:2]
    return dataclasses.replace(
        reduced_config(REGISTRY[arch], n_layers=2, d_model=64, **over),
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
    _, _, _, policy, rs, seq, batch = CASES[name]
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
        shape = CASES[name][2]
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
                        list(CASES[n][2]), *CASES[n][3:]] for n in names])


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
