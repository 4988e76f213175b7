"""Dry run: plan one rank of every (arch × shape × mesh) cell on the
meta device. Port of ``src/repro/launch/dryrun.py``.

The reference forges 512 host devices, lowers the real train, prefill or
serve step on the production mesh (16 × 16, or 2 × 16 × 16 with
``--mesh multi``) with ``ShapeDtypeStruct`` inputs and compiles it. The
port has no compiler to ask: it runs ONE rank's real step eagerly on the
meta device (shapes and dtypes only: nothing allocated, nothing
computed) against a ``runtime.sharding.PlanMesh``, a process mesh with
the grid's axes and extents, that rank's coordinates and no process
group. The sharded model and ``make_train_step``, ``make_serve_step``
and ``make_prefill_step`` run on it unchanged. ``roofline/analysis.py``
counts the pass: FLOPs (``FlopCounterMode``), the bytes every op reads
and writes, the live storages' peak, and the collectives the step called
(kind, result bytes and group size, through the reference's ring
model). The result has the reference's keys: ``memory`` and
``fits_hbm`` (the H100's 80 GB), ``roofline_hlo_raw`` (the meta pass's
raw counts under the H100's peaks) and ``roofline`` (the analytic model
``roofline/flops_model.py`` under the same peaks, with ``dominant`` and
``mfu_bound_overlap``); ``plan_seconds`` stands where the reference has
``compile_seconds``.

``--lda`` plans the paper's own model: one rank of the distributed
EZLDA step at the reference's shard sizes (``lower_lda``).

Usage::

    python -m repro_torch.launch.dryrun --arch deepseek-moe-16b \\
        --shape train_4k --mesh multi --out results/cell.json
    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --lda --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import REGISTRY, SHAPES, shape_applicable
from repro_torch.lda.distributed import (SWEEP_CHUNK_BYTES, DistLDAState,
                                         DistLDATrainer, _Moves)
from repro_torch.lda.model import LDAConfig
from repro_torch.models.registry import (get_model, init_rank_params,
                                         input_specs, make_rank_cache,
                                         param_shapes)
from repro_torch.models.tree import tree_items
from repro_torch.roofline.analysis import (H100, meter_pass, roofline_terms,
                                           summarize_memory)
from repro_torch.roofline.flops_model import analytic_cell
from repro_torch.runtime.sharding import PlanMesh, batch_axes
from repro_torch.train import partition
from repro_torch.train.serve_step import (make_prefill_step, make_serve_step,
                                          serve_state_shardings)
from repro_torch.train.train_step import default_microbatches, make_train_step

__all__ = ["plan_mesh", "plan_step", "lower_cell", "plan_cell",
           "lower_lda", "main"]


def plan_mesh(multi_pod: bool) -> PlanMesh:
    """The production grid (16 × 16, or 2 × 16 × 16) to plan rank 0 on:
    the axes of ``launch/mesh.py::production_mesh_shape``."""
    if multi_pod:
        return PlanMesh((2, 16, 16), ("pod", "data", "model"))
    return PlanMesh((16, 16), ("data", "model"))


def plan_step(api, kind: str, mesh, seq_len: int, global_batch: int, *,
              n_micro: int = 1, policy: str = "tp",
              rs_per_micro: bool = True) -> dict:
    """One rank's step of ``kind`` ("train", "prefill" or "decode") on
    ``mesh`` (a ``PlanMesh``, or None for one device), metered. ``api``
    is a model on the meta device, or on a real one to count a real step
    (``chip_smoke.py`` holds the two to each other). Returns the FLOPs,
    bytes, memory, the mesh's traffic and the pass's seconds."""
    cfg = api.cfg
    enc = cfg.is_encoder_decoder
    if kind == "train":
        step, init = make_train_step(api, mesh, n_micro,
                                     policy=policy,
                                     rs_per_micro=rs_per_micro)
        state = init(0)
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device=api.device)
                 for k, v in input_specs(cfg, seq_len, global_batch,
                                         "train").items()}
        args = (state, batch)
    elif kind == "prefill":
        step = make_prefill_step(api, mesh)
        params = _serving_params(api, mesh)
        spec = input_specs(cfg, seq_len, global_batch, "prefill")
        x = spec["frames" if enc else "inputs"]
        args = (params, torch.empty(x.shape, dtype=x.dtype,
                                    device=api.device))
    else:
        enc_len = seq_len if enc else None
        specs = None
        if mesh is not None:
            specs = serve_state_shardings(api, mesh, global_batch, seq_len,
                                          enc_len)[3]
        step = make_serve_step(api, mesh, specs)
        params = _serving_params(api, mesh)
        cache = api.make_cache(global_batch, seq_len,
                               **({"enc_len": enc_len} if enc else {})) \
            if mesh is None else make_rank_cache(api, mesh, specs,
                                                 global_batch, seq_len,
                                                 enc_len)
        tok = input_specs(cfg, seq_len, global_batch, "decode")["tokens"]
        args = (params, cache, torch.empty(tok.shape, dtype=tok.dtype,
                                           device=api.device))
    if mesh is not None:
        mesh.traffic.clear()
    out, flops, meter, secs = meter_pass(step, *args, inputs=args)
    return {"flops": flops, "bytes": meter.read + meter.written,
            "ops": meter.ops, "memory": summarize_memory(meter, out),
            "traffic": {} if mesh is None else dict(mesh.traffic),
            "seconds": secs}


def _serving_params(api, mesh):
    """The params a serving rank holds: the whole model on one device,
    else its blocks under ``zero1_specs`` (the reference's serving
    layout)."""
    if mesh is None:
        return api.init(0)
    return init_rank_params(api, mesh, partition.zero1_specs(
        mesh, param_shapes(api.cfg)), 0)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               n_micro: int | None = None, policy: str = "tp",
               remat: str | None = None, seq_parallel: bool = True,
               rs_per_micro: bool = True) -> dict:
    """Plan one cell: rank 0's step of ``arch`` at ``shape_name`` on the
    production mesh (the reference's arguments)."""
    cfg = REGISTRY[arch]
    overrides = {}
    if remat is not None:
        overrides["remat"] = remat
    if not seq_parallel:
        overrides["seq_parallel"] = False
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return plan_cell(cfg, SHAPES[shape_name], multi_pod, n_micro=n_micro,
                     policy=policy, rs_per_micro=rs_per_micro)


def plan_cell(cfg, shape, multi_pod: bool, n_micro: int | None = None,
              policy: str = "tp", rs_per_micro: bool = True) -> dict:
    """``lower_cell`` of a config and a shape: rank 0's step on the
    production mesh, metered, with the reference's result keys."""
    arch, shape_name = cfg.name, shape.name
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}
    mesh = plan_mesh(multi_pod)
    api = get_model(cfg, "meta")
    n_params = sum(int(np.prod(t.shape))
                   for _, t in tree_items(param_shapes(cfg)))
    extra = {}
    micro = 1
    if shape.kind == "train":
        micro = n_micro or default_microbatches(cfg, shape, mesh, policy)
        extra["n_microbatches"] = micro
    got = plan_step(api, shape.kind, mesh, shape.seq_len, shape.global_batch,
                    n_micro=micro, policy=policy, rs_per_micro=rs_per_micro)
    hw = H100()
    mem = got["memory"]
    rf = roofline_terms(got["flops"], got["bytes"], got["traffic"], hw)
    cost = analytic_cell(cfg, shape, dict(mesh.shape), n_micro=micro,
                         policy=policy, rs_per_micro=rs_per_micro)
    terms = cost.terms(hw)
    dominant = max(terms, key=terms.get)
    total = sum(terms.values())
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": dict(mesh.shape),
        "coords": dict(mesh.coords),
        "status": "ok",
        "n_params": n_params,
        "n_active_params": cfg.active_param_count(),
        "plan_seconds": round(got["seconds"], 1),
        "ops": got["ops"],
        "memory": mem,
        "fits_hbm": mem["peak_bytes_estimate"] < hw.hbm_bytes,
        "hardware": dataclasses.asdict(hw) | {"name": "H100 SXM5 80 GB"},
        # the meta pass's raw counts: every layer, micro-batch, recompute
        # and backward; bytes are eager op-by-op traffic (no fusion)
        "roofline_hlo_raw": rf,
        # the analytic model (the headline roofline numbers)
        "roofline": {
            **terms,
            "dominant": dominant,
            "flops": cost.flops,
            "hbm_bytes": cost.hbm_bytes,
            "wire_bytes": cost.wire_bytes,
            "model_flops": cost.model_flops,
            "useful_compute_ratio": (cost.model_flops / cost.flops
                                     if cost.flops else 0.0),
            "step_time_bound_s": max(terms.values()),
            # roofline fraction = useful-compute time / step time
            "mfu_bound_overlap": (cost.model_flops / hw.peak_flops
                                  / max(terms.values())) if total else 0.0,
            "mfu_no_overlap": (cost.model_flops / hw.peak_flops / total)
                              if total else 0.0,
            "detail": cost.detail,
        },
        **extra,
    }


class PlannedRank(DistLDATrainer):
    """A ``DistLDATrainer`` rank on the meta device at given shard sizes
    (V words, ``n_loc`` token slots and ``m_loc`` documents a data shard)
    in its resident dense layout, with no corpus: what ``lower_lda``
    plans. Its host reads are planned at capacity: every real token
    draws and every token moves. A model axis over 1 runs the topic
    split, plain PyTorch; on a model axis of 1 the sweep is the
    hand-written kernels, which do not run on meta."""

    def __init__(self, config, mesh: PlanMesh, *, n_words: int, n_loc: int,
                 m_loc: int):
        # what the resident iteration (``_step``) reads
        pm = mesh.shape["model"]
        if pm == 1 or config.n_topics % pm:
            raise ValueError(
                f"a plan needs the topic split: a model axis over 1 that "
                f"divides n_topics={config.n_topics}, not {pm}")
        meta = torch.device("meta")
        self.cfg, self.mesh, self.device = config, mesh, meta
        self.data_axes = batch_axes(mesh)
        self.pm, self.n_words = pm, n_words
        self.k_local = config.n_topics // pm
        self.kb0 = mesh.axis_index("model") * self.k_local
        self.n_docs_local = m_loc
        self.n_shared, self.shared_rows, self.shared_slot = 0, None, None
        self.stream = self.pipe = self.layout = self.sc = None
        i32 = dict(dtype=torch.int32, device=meta)
        self.word_ids, self.doc_ids, self.mask = (torch.empty(n_loc, **i32)
                                                  for _ in range(3))
        self.global_pos = torch.empty(n_loc, dtype=torch.int64, device=meta)
        self._delta = torch.zeros((n_words + 1, self.k_local), **i32)
        self.sweep_tokens = max(1024, SWEEP_CHUNK_BYTES // (4 * self.k_local))
        # the rank's state, and what it holds beside it
        self.state = DistLDAState(
            torch.empty(n_loc, **i32),
            torch.empty((m_loc, self.k_local), **i32),
            torch.empty((n_words, self.k_local), **i32),
            torch.empty(self.k_local, **i32), 0)
        self.arrays = (self.word_ids, self.doc_ids, self.mask,
                       self.global_pos, self._delta)

    def _uniforms(self, iteration, global_pos):
        return torch.empty(global_pos.shape, dtype=torch.float32,
                           device=self.device)

    @staticmethod
    def _survivors(skip, mask):
        return mask.shape[0]

    @staticmethod
    def _moves(mask, topics, new_topics):
        return _Moves(torch.arange(topics.shape[0], device=topics.device),
                      topics, new_topics)


def lower_lda(multi_pod: bool, n_topics: int = 1024, v: int = 65_536,
              n_loc: int = 262_144, m_loc: int = 8_192) -> dict:
    """Plan the paper's own model: one rank of the distributed EZLDA step
    on the production mesh at the reference's shard sizes (V = 64 Ki
    words, 256 Ki tokens and 8 Ki docs a data shard, K topics over
    ``model``), in ``DistLDATrainer``'s resident dense layout
    (``PlannedRank``). On a model axis over 1 the step is the topic
    split, plain PyTorch (no hand-written kernel), so its FLOPs, bytes
    and collectives are the meta pass's. Its host reads, the survivor
    count and the changed tokens' list (a data-dependent shape), are
    planned at capacity: every token moves."""
    mesh = plan_mesh(multi_pod)
    tr = PlannedRank(LDAConfig(n_topics=n_topics), mesh, n_words=v,
                     n_loc=n_loc, m_loc=m_loc)
    out, flops, meter, secs = meter_pass(tr._step, tr.state,
                                         inputs=(tr.state, tr.arrays))
    hw = H100()
    mem = summarize_memory(meter, out)
    return {
        "arch": f"lda-ezlda-K{n_topics}", "shape": f"tokens{n_loc}pershard",
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": dict(mesh.shape), "coords": dict(mesh.coords),
        "status": "ok",
        "plan_seconds": round(secs, 1),
        "memory": mem, "fits_hbm": mem["peak_bytes_estimate"] < hw.hbm_bytes,
        "roofline": roofline_terms(flops, meter.read + meter.written,
                                   mesh.traffic, hw),
        "planned_at_capacity": "the host reads, the survivor count and the "
                               "changed tokens' list (nonzero), at "
                               "capacity: every token moves in the ±1 "
                               "scatters",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(REGISTRY))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--lda", action="store_true",
                    help="plan the paper's own distributed LDA step")
    ap.add_argument("--topics", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--policy", choices=["tp", "dp", "fsdp", "ep"],
                    default="tp",
                    help="dp: repurpose the model axis as data parallelism")
    ap.add_argument("--remat", choices=["full", "none"], default=None)
    ap.add_argument("--no-sp", action="store_true",
                    help="the reference's sequence-parallel residual off "
                         "(changes nothing in the port: its residual is "
                         "replicated over model)")
    ap.add_argument("--rs-once", action="store_true",
                    help="single step-end grad reduce-scatter")
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in sorted(REGISTRY):
            for s in SHAPES:
                ok, why = shape_applicable(REGISTRY[a], SHAPES[s])
                print(f"{a:24s} {s:12s} {'run' if ok else 'SKIP: ' + why}")
        return 0

    if args.lda:
        result = lower_lda(args.mesh == "multi", n_topics=args.topics)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --list/--lda)")
        result = lower_cell(args.arch, args.shape, args.mesh == "multi",
                            n_micro=args.microbatches, policy=args.policy,
                            remat=args.remat, seq_parallel=not args.no_sp,
                            rs_per_micro=not args.rs_once)

    print(json.dumps(result, indent=2, default=float))
    if args.out:
        result.setdefault("policy", args.policy)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2, default=float)
    return 0 if result["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
