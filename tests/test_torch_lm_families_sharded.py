"""The port's sharded train step for the SSM, hybrid, MLA and
encoder-decoder families and under the fsdp policy, against the
reference's sharded step and the port's one-device step, on the CPU.

Gloo worlds of 4 and 2 spawned processes (``tests/_torch_dist.py::
run_world``) train the cases of ``tests/_torch_lm_dist.py::FAMILY_CASES``
two steps each, reduced float32 configs, tensor-parallel on (2, 2):
mamba2-370m (each rank runs the SSD on its heads), zamba2-1.2b (two uses
of the shared block), minicpm3-4b (MLA, q_norm over the gathered rank)
and whisper-base (tensor-parallel encoder, decoder and cross-attention;
on (1, 2) with 33 frames too); qwen1.5-0.5b under fsdp on (2, 2) and
zamba2 under fsdp on (1, 2): every leaf stored in blocks over every
axis, gathered when its block runs and reduce-scattered in the
backward. The reference's ``make_train_step`` runs the same cases on
forged CPU devices (``runtime/compat.make_mesh``) in two subprocesses
started first, from the same weights and batches (the reference's
compiles are this file's main cost: seven cases, not more).

Tolerances (``test_torch_lm_sharded.py``'s): every rank reports the same
metrics; loss and grad norm within 1e-5 relative of the reference's
sharded step and of the port's one-device step; at most 0.1% of the
final master weights differ by more than 1e-6 from either. AdamW's eps is
1e-3 for the families but qwen (``_torch_lm_dist.SMOOTH``).

The world of 2 also runs ``train_lm`` of each of the four families on
the (1, 2) mesh it picks by itself, held to the one-device ``train_lm``
(reduced bfloat16: losses within 1e-2).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_lm_dist as L
from _torch_dist import run_world
from repro_torch.launch.train import train_lm
from repro_torch.models.registry import param_shapes
from repro_torch.models.tree import tree_items
from repro_torch.runtime.sharding import MeshShape
from repro_torch.train.partition import param_specs

ROOT = Path(__file__).resolve().parents[1]
REF_SPLIT = 2                  # reference subprocesses, side by side


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_families_sharded")
    for name in L.FAMILY_CASES:
        L.save_weights(name, d / f"{name}.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    names = sorted(L.FAMILY_CASES)
    procs = []
    for i in range(REF_SPLIT):
        part = names[i::REF_SPLIT]
        procs.append((d / f"ref{i}.npz", subprocess.Popen(
            [sys.executable, "-c", L.REFERENCE, L.reference_args(part),
             str(d), str(d / f"ref{i}.npz")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    yield d, procs
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def worlds(weights):
    d, _ = weights
    ranks4 = run_world(4, "_torch_lm_dist:families", (L.FAMILY4, str(d)),
                       d, timeout=300)
    ranks2 = run_world(2, "_torch_lm_dist:families", (L.FAMILY2, str(d)),
                       d, timeout=300)
    return ranks4, ranks2


@pytest.fixture(scope="module")
def reference(weights):
    out = {}
    for path, p in weights[1]:
        _, err = p.communicate(timeout=500)
        assert p.returncode == 0, err[-3000:]
        out.update(L.read_reference(path))
    return out


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), (what, got, want)


def _masters(got: dict, want: dict, what: str) -> None:
    off = total = 0
    for name, w in want.items():
        d = np.abs(got[name] - w)
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= total // 1000, (what, off, total)


@pytest.mark.parametrize("name", sorted(L.FAMILY_CASES))
def test_family_step_matches_reference_and_one_device(name, weights,
                                                      worlds, reference):
    ranks = worlds[0] if name in L.FAMILY4 else worlds[1]
    got = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["loss"] == got["loss"], name
        assert r[name]["grad_norm"] == got["grad_norm"], name
    sides = {"reference": reference[name],
             "one device": L.one_device(name, str(weights[0]
                                                  / f"{name}.npz"))}
    for side, want in sides.items():
        for i in range(L.STEPS):
            _close(got["loss"][i], want["loss"][i], 1e-5, (side, "loss", i))
            _close(got["grad_norm"][i], want["grad_norm"][i], 1e-5,
                   (side, "grad_norm", i))
        _masters(got["master"], want["master"], side)


@pytest.mark.parametrize("name", sorted(k for k in L.FAMILY_CASES
                                        if "_fsdp_" in k))
def test_fsdp_holds_only_the_ranks_blocks(name, worlds):
    """Between steps an fsdp rank holds its block of every leaf over
    every axis (``param_specs(policy="fsdp")``), never a gathered one;
    the gathers of a step move each split leaf once a block run and its
    reduce-scatter once a micro-batch."""
    ranks = worlds[0] if name in L.FAMILY4 else worlds[1]
    shape = L.FAMILY_CASES[name][2]
    mesh = MeshShape(shape, ("data", "model"))
    full = param_shapes(L.config(name))
    specs = dict(tree_items(param_specs(mesh, full, "fsdp")))
    n = int(np.prod(shape))
    split = 0
    for path, t in tree_items(full):
        want = list(t.shape)
        for i, e in enumerate(tuple(specs[path])):
            if e is not None:
                want[i] //= n
                split += 1
        for r in ranks:
            assert r[name]["shapes"][path] == tuple(want), path
    assert split and "reduce_scatter" in ranks[0][name]["traffic"]
    assert "all_gather" in ranks[0][name]["traffic"]


@pytest.mark.parametrize("arch", L.FAMILY_ARCHS)
def test_train_lm_on_a_mesh_runs_the_family(arch, worlds):
    """train_lm in a world of 2 picks the (1, 2) mesh by itself; its
    losses follow the one-device train_lm's (reduced bfloat16)."""
    got = [r[f"train_lm/{arch}"] for r in worlds[1]]
    assert got[0] == got[1]
    want = train_lm(arch, **L.FAMILY_LAUNCH, device="cpu",
                    log_fn=lambda _line: None)["loss"]
    assert len(got[0]) == len(want) == L.FAMILY_LAUNCH["steps"]
    for g, w in zip(got[0], want):
        _close(g, w, 1e-2, (arch, "loss"))
