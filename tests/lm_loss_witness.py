"""The reference's and the port's loss curves at a published width, on
the CPU: a second witness for what ``chip_smoke.py``'s ``lm_families``
sees on the card.

The reference initializes a config at its published width (depth cut to
``--layers``); its weights are carried into the port bit for bit
(``models/convert.py``). Both then take ``--steps`` AdamW steps with
``train_lm``'s schedule (warmup ``max(steps // 20, 5)``, cosine to
``steps``) on the same synthetic batches, and the port also evaluates
the initial weights on each of those batches (the lr = 0 curve). Each
curve is printed, with the largest relative gap between the two
packages' losses, and written as JSON to ``--out``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_loss_witness.py \\
        --arch minicpm3-4b --layers 2 --seq 2048 --steps 6

A two-layer minicpm3-4b in float32 holds ~0.5 B params: its run peaks at
~22 GiB, one package after the other.

``--port-only`` leaves JAX out and runs the port alone on ``--device``
(default the CUDA card), initialized as ``train_lm`` initializes it, at
each ``--lr`` in turn: the curves that ``chip_smoke.py``'s
``lm_families`` (a) draws, beside their lr = 0 curve, at any depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY
from repro_torch.data.synthetic import make_batch
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def port_curve(api, params, batches: list, steps: int, lr: float) -> dict:
    """The lr = 0 curve of ``params``, then ``steps`` AdamW steps."""
    with torch.no_grad():
        lr0 = [float(api.loss(params, b)) for b in batches]
    step, _ = make_train_step(api, n_micro=1, opt_cfg=opt.AdamWConfig(
        lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps))
    state = {"params": params, "opt": opt.init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=api.device)}
    loss, gnorm, lrs = [], [], []
    for b in batches:
        state, m = step(state, b)
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    return {"loss": loss, "grad_norm": gnorm, "lr": lrs, "lr0_loss": lr0}


def curves(arch: str, layers: int, seq: int, batch: int, steps: int,
           lr: float, dtype: str, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY as JREGISTRY
    from repro.models.registry import get_model as jget_model
    from repro.runtime.compat import make_mesh
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step as jmake_train_step
    jcfg = dataclasses.replace(JREGISTRY[arch], n_layers=layers,
                               param_dtype=dtype)
    cfg = dataclasses.replace(REGISTRY[arch], n_layers=layers,
                              param_dtype=dtype)
    warmup = max(steps // 20, 5)
    batches = [make_batch(cfg, seq, batch, "train", step=i, seed=seed)
               for i in range(steps)]
    out = {"arch": arch, "layers": layers, "seq": seq, "batch": batch,
           "lr": lr, "dtype": dtype, "seed": seed,
           "param_count": cfg.param_count()}

    t0 = time.perf_counter()
    jstep, jinit = jmake_train_step(
        jget_model(jcfg), make_mesh((1, 1), ("data", "model")), n_micro=1,
        opt_cfg=jopt.AdamWConfig(lr=lr, warmup_steps=warmup,
                                 total_steps=steps))
    jstate = jinit(jax.random.PRNGKey(seed))
    init = jax.tree.map(np.asarray, jstate["params"])
    jstep = jax.jit(jstep)
    ref = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append((float(m["loss"]), float(m["grad_norm"]),
                    float(m["lr"])))
    del jstate, jstep, jinit
    gc.collect()
    out["reference"] = {"loss": [r[0] for r in ref],
                        "grad_norm": [r[1] for r in ref],
                        "lr": [r[2] for r in ref],
                        "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    api = get_model(cfg, "cpu")
    params = params_from_reference(init, cfg, "cpu")
    del init
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    port = port_curve(api, params, tb, steps, lr)
    out["lr0_loss"] = port.pop("lr0_loss")
    out["port"] = dict(port, seconds=time.perf_counter() - t0)
    out["max_rel_loss_gap"] = max(
        abs(p - r[0]) / abs(r[0]) for p, r in zip(port["loss"], ref))
    return out


def port_curves(arch: str, layers: int, seq: int, batch: int, steps: int,
                lrs: list, dtype: str, seed: int, device) -> list:
    """The port alone on ``device``: one fresh init a learning rate."""
    cfg = dataclasses.replace(REGISTRY[arch], n_layers=layers,
                              param_dtype=dtype)
    api = get_model(cfg, device)
    batches = [{k: torch.from_numpy(v).to(api.device) for k, v in make_batch(
        cfg, seq, batch, "train", step=i, seed=seed).items()}
        for i in range(steps)]
    out = []
    for lr in lrs:
        t0 = time.perf_counter()
        r = port_curve(api, api.init(seed), batches, steps, lr)
        out.append(dict(r, arch=arch, layers=layers, seq=seq, batch=batch,
                        peak_lr=lr, dtype=dtype, seed=seed, device=str(api.device),
                        seconds=time.perf_counter() - t0))
        if api.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm3-4b", choices=sorted(REGISTRY))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-4])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port-only", action="store_true",
                    help="the port alone, no JAX, at each --lr")
    ap.add_argument("--device", default=None,
                    help="the port's device with --port-only (default: "
                         "the CUDA card)")
    ap.add_argument("--out", default=None, help="write the curves as JSON")
    a = ap.parse_args(argv)
    if a.port_only:
        rs = port_curves(a.arch, a.layers, a.seq, a.batch, a.steps, a.lr,
                         a.dtype, a.seed, a.device)
        for r in rs:
            print(f"{a.arch}, {a.layers} layers at the published width, "
                  f"{a.dtype}, {a.batch} x {a.seq} tokens a step, lr "
                  f"{r['peak_lr']:g}, the port on {r['device']} "
                  f"({r['seconds']:.1f} s):")
            print("step  lr          port       lr=0       port - lr=0")
            for i, (pl, l0, lr) in enumerate(zip(r["loss"], r["lr0_loss"],
                                                 r["lr"]), 1):
                print(f"{i:4d}  {lr:.3e}  {pl:9.5f}  {l0:9.5f}  "
                      f"{pl - l0:+.5f}")
        if a.out:
            with open(a.out, "w") as f:
                json.dump(rs, f, indent=1)
        return 0
    if len(a.lr) != 1:
        ap.error("one --lr without --port-only")
    a.lr = a.lr[0]
    r = curves(a.arch, a.layers, a.seq, a.batch, a.steps, a.lr, a.dtype,
               a.seed)
    print(f"{a.arch}, {a.layers} layers at the published width "
          f"({r['param_count']:,} params), {a.dtype}, {a.batch} x {a.seq} "
          f"tokens a step, lr {a.lr:g}:")
    print("step  lr          reference  port       lr=0       "
          "port - lr=0")
    for i, (jl, pl, l0, lr) in enumerate(zip(
            r["reference"]["loss"], r["port"]["loss"], r["lr0_loss"],
            r["reference"]["lr"]), 1):
        print(f"{i:4d}  {lr:.3e}  {jl:9.5f}  {pl:9.5f}  {l0:9.5f}  "
              f"{pl - l0:+.5f}")
    print(f"largest relative gap, port vs reference: "
          f"{r['max_rel_loss_gap']:.3e}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(r, f, indent=1)
    print(json.dumps({k: r[k] for k in ("arch", "max_rel_loss_gap")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
