"""The port's roofline and dry run (``repro_torch.roofline``,
``repro_torch.launch.dryrun``) against the reference's, on the CPU.

* ``analytic_cell`` equals the reference's to 1e-12 relative in every
  number, for every config, shape, mesh (single, multi, (4, 4)), policy
  and ``rs_per_micro``;
* the ring model equals the reference's ``collective_bytes`` fed the
  same kind, result bytes and group size (synthetic HLO lines for the
  reference, as ``tests/test_roofline.py`` writes them);
* the meta pass's FLOPs of one rank's train step fall within the
  0.85-1.2 band of ``analytic_cell`` that the reference's calibration
  test asks of its unrolled HLO: qwen1.5-0.5b and mamba2-370m at 4
  layers, seq 512, batch 8, on a (4, 4) plan mesh;
* a ``PlanMesh`` counts what a step calls; ``Meter`` tracks live bytes;
* the dry run's command line plans whisper-base decode_32k on the multi
  mesh with the reference's result keys, and ``lower_lda`` plans the
  paper's distributed step;
* every (arch × shape) cell is planned on the single 16 × 16 mesh at one
  layer and an eighth of its sequence (the cut keeps every layout's
  divisibility), ``ok`` or ``skipped`` with the reference's reason; none
  is refused. (The full-depth sweep is the command line's, run by hand:
  PERF.md.)
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import shape_applicable as ref_applicable
from repro.roofline import analysis as ref_analysis
from repro.roofline.flops_model import analytic_cell as ref_cell
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.launch.dryrun import lower_lda, plan_cell, plan_step
from repro_torch.models.registry import get_model
from repro_torch.roofline.analysis import (H100, HW, Meter, collective_bytes,
                                           roofline_terms)
from repro_torch.roofline.flops_model import analytic_cell
from repro_torch.runtime.sharding import PlanMesh, ring_bytes

ROOT = Path(__file__).resolve().parents[1]
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 4})


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_analytic_cell_equals_the_reference(arch):
    cfg, ref = REGISTRY[arch], REF_REGISTRY[arch]
    for (sname, mesh, policy, rs, micro) in itertools.product(
            SHAPES, MESHES, ("tp", "dp", "fsdp", "ep"), (True, False),
            (1, 4)):
        got = analytic_cell(cfg, SHAPES[sname], mesh, n_micro=micro,
                            policy=policy, rs_per_micro=rs)
        want = ref_cell(ref, REF_SHAPES[sname], mesh, n_micro=micro,
                        policy=policy, rs_per_micro=rs)
        what = (sname, mesh, policy, rs, micro)
        for k in ("flops", "model_flops", "hbm_bytes", "wire_bytes"):
            assert _rel(getattr(got, k), getattr(want, k)) <= 1e-12, \
                (what, k)
        assert got.detail.keys() == want.detail.keys(), what
        for k, v in want.detail.items():
            assert _rel(got.detail[k], float(v)) <= 1e-12, (what, k)
        for k, v in want.terms(ref_analysis.HW()).items():
            assert _rel(got.terms(HW())[k], v) <= 1e-12, (what, k)


def test_hardware_constants():
    ref = ref_analysis.HW()
    assert (HW().peak_flops, HW().hbm_bw, HW().link_bw, HW().hbm_bytes) == (
        ref.peak_flops, ref.hbm_bw, ref.link_bw, ref.hbm_bytes)
    h = H100()
    assert (h.peak_flops, h.hbm_bw, h.link_bw, h.hbm_bytes,
            h.power_limit_w) == (989e12, 3.35e12, 450e9, 80e9, 700.0)


def test_ring_model_equals_the_reference():
    """Every kind at several result sizes and group sizes: the port's
    ``collective_bytes`` over (kind, result bytes, group size) calls
    against the reference's over the same calls written as HLO."""
    dtype = {"f32": 4, "bf16": 2, "s32": 4}
    hlo, calls = [], []
    for i, (kind, (dt, n), g) in enumerate(itertools.product(
            ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"),
            (("f32", 1024), ("bf16", 96), ("s32", 7)), (2, 4, 16))):
        group = ",".join(str(r) for r in range(g))
        hlo.append(f"  %c{i} = {dt}[{n}]{{0}} {kind}({dt}[{n}]{{0}} %x), "
                   f"replica_groups={{{{{group}}}}}")
        calls.append((kind.replace("-", "_"), n * dtype[dt], g))
    want = ref_analysis.collective_bytes("\n".join(hlo), 16)
    got = collective_bytes(calls)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert _rel(got[k], v) <= 1e-12, k
    for kind, nbytes, g in calls:
        one = ref_analysis.collective_bytes(
            f"%a = s8[{nbytes}]{{0}} {kind.replace('_', '-')}(s8[{nbytes}]"
            f"{{0}} %x), replica_groups={{{{{','.join(map(str, range(g)))}"
            "}}", 16)
        assert _rel(ring_bytes(kind, nbytes, g),
                    one[kind.replace("_", "-")]) <= 1e-12


def test_plan_mesh_counts_what_is_called():
    """A PlanMesh's collectives shape their results and count, by kind
    and group size, the bytes a ProcessMesh hands to all_reduce and the
    result's; its traffic feeds the ring model."""
    mesh = PlanMesh((2, 4), ("data", "model"), rank=5)
    assert mesh.coords == {"data": 1, "model": 1}
    x = torch.empty((3, 8), device="meta")
    assert mesh.all_gather(x, "model").shape == (4, 3, 8)
    assert mesh.reduce(x, "model", "reduce_scatter").shape == (3, 8)
    assert mesh.psum(x, ("data", "model")) is x
    mesh.barrier()
    assert not mesh.vote().any()
    t = mesh.traffic
    assert t["all_gather"][:2] == [1, 4 * 96] and \
        t["all_gather"][2] == {4: [1, 4 * 96]}
    assert t["reduce_scatter"][2] == {4: [1, 96 // 4]}
    assert t["all_reduce"][2] == {8: [1, 96]}
    got = collective_bytes(t)
    assert got["count"] == 3
    assert got["all-gather"] == ring_bytes("all_gather", 384, 4)
    assert got["reduce-scatter"] == ring_bytes("reduce_scatter", 24, 4)
    assert got["all-reduce"] == ring_bytes("all_reduce", 96, 8)
    terms = roofline_terms(1e12, 1e9, t)
    assert terms["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert terms["compute_s"] == 1e12 / H100().peak_flops


def test_meter_tracks_bytes_and_the_live_peak():
    a = torch.empty(1000, device="meta")                  # 4,000 bytes
    with Meter(a) as m:
        b = a * 2                                         # +4,000
        c = b + 1                                         # +4,000: peak
        del b                                             # -4,000
        d = c.view(10, 100)                               # a view: free
        e = d.sum()
    assert m.arguments == 4000 and m.peak == 12_000
    assert m.now == 8004                                  # a, c and e
    assert m.read == 4000 + 4000 + 4000 and m.written == 4000 + 4000 + 4
    del c, d, e


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m"])
def test_meta_flops_within_the_calibration_band(arch):
    cfg = dataclasses.replace(REGISTRY[arch], n_layers=4)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=512,
                                global_batch=8)
    got = plan_step(get_model(cfg, "meta"), "train",
                    PlanMesh((4, 4), ("data", "model")), 512, 8, n_micro=1)
    ratio = got["flops"] / analytic_cell(cfg, shape, {"data": 4, "model": 4},
                                         n_micro=1).flops
    assert 0.85 < ratio < 1.2, ratio
    assert got["traffic"] and got["memory"]["peak_bytes_estimate"] > 0


def test_dryrun_cell_end_to_end():
    """The command line on the multi mesh, as the reference's own test
    runs its dry run: whisper-base decode_32k."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--mesh", "multi"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    d = json.loads(proc.stdout)
    assert d["status"] == "ok"
    assert d["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert d["roofline"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    assert d["roofline_hlo_raw"]["collectives"]["count"] > 1
    for k in ("n_params", "memory", "fits_hbm", "roofline_hlo_raw",
              "roofline"):
        assert k in d, k
    for k in ("mfu_bound_overlap", "mfu_no_overlap", "step_time_bound_s",
              "model_flops", "useful_compute_ratio", "detail"):
        assert k in d["roofline"], k
    assert d["memory"]["peak_bytes_estimate"] > 0


def test_lda_plan():
    d = lower_lda(False)
    assert d["status"] == "ok" and d["mesh_shape"] == {"data": 16,
                                                       "model": 16}
    v, k_loc, n_loc, m_loc = 65_536, 1024 // 16, 262_144, 8_192
    state = 4 * (n_loc + m_loc * k_loc + v * k_loc + k_loc)
    arrays = 4 * 3 * n_loc + 8 * n_loc + 4 * (v + 1) * k_loc
    assert d["memory"]["argument_size_in_bytes"] == state + arrays
    assert d["roofline"]["collectives"]["count"] > 1
    assert "capacity" in d["planned_at_capacity"]


def test_every_cell_is_planned_on_the_production_mesh():
    """One layer and an eighth of each shape's sequence (16 still divides
    it): every layout and route the full cell takes, cheaply."""
    for arch in sorted(REGISTRY):
        cut = dataclasses.replace(REGISTRY[arch], n_layers=1)
        for sname, shape in SHAPES.items():
            got = plan_cell(cut, dataclasses.replace(
                shape, seq_len=shape.seq_len // 8), False, n_micro=1)
            ok, why = ref_applicable(REF_REGISTRY[arch], REF_SHAPES[sname])
            assert got["status"] == ("ok" if ok else "skipped"), (arch,
                                                                   sname)
            if not ok:
                assert got["reason"] == why
                continue
            assert got["mesh_shape"] == {"data": 16, "model": 16}
            assert got["roofline_hlo_raw"]["hlo_flops"] > 0, (arch, sname)
            assert got["fits_hbm"], (arch, sname)
