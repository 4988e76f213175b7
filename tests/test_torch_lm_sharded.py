"""The port's sharded LM train step against the reference's and against
its own one-device step, on the CPU.

Gloo worlds of 4 and 2 spawned processes (``tests/_torch_dist.py::
run_world``) train the cases of ``tests/_torch_lm_dist.py`` two steps
each: qwen1.5-0.5b tensor-parallel with ZeRO-1 on (2, 2) and (1, 4)
and data-parallel on (4, 1), under both accumulation schedules;
deepseek-moe-16b on (2, 2) with the all-to-all over ``model`` (tp) and
over every axis (ep) at capacity factor 64, and at the default capacity
where tokens overflow; granite-moe-3b-a800m with six experts padded to
eight on (1, 2), where a sequence of 33 takes the replicated-activation
route. The reference's ``make_train_step`` runs the same cases on forged
CPU devices (``runtime/compat.make_mesh``) in two subprocesses started
first, from the same weights and batches.

Tolerances: every rank reports the same metrics; loss and grad norm
within 1e-5 relative of the reference's sharded step and of the port's
one-device step; at most 0.1% of the final master weights differ by
more than 1e-6 from either, each by less than the two steps' 2·Σlr
(``test_torch_lm_train.py``'s criterion: at AdamW's default eps a
gradient at the rounding floor moves its weight by ±lr on a sign either
side may take). The
overflow case is held to the reference's sharded step only: its dropped
tokens are the all-to-all's, not the one-device dispatch's.

Also: a mesh of one rank is bitwise the one-device step; ``train_lm`` on
(2, 2) logs from rank 0 only and its payload resumes on one device;
``torch.distributed.run`` with two ranks trains the launcher and resumes
it bitwise; and every refusal names #14c-2.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_lm_dist as L
from _torch_dist import run_world, world1
from repro_torch.configs import REGISTRY
from repro_torch.launch.train import train_lm
from repro_torch.models.registry import get_model, reduced_config
from repro_torch.models.tree import tree_items
from repro_torch.runtime.sharding import MeshShape, ProcessMesh
from repro_torch.train.serve_step import make_prefill_step, make_serve_step
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
REF_SPLIT = 2                  # reference subprocesses, side by side


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Every case's weights, and the reference's runs started on them."""
    d = tmp_path_factory.mktemp("lm_sharded")
    for name in L.CASES:
        L.save_weights(name, d / f"{name}.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    names = sorted(L.CASES)
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
    ranks4 = run_world(4, "_torch_lm_dist:sharded",
                       (L.WORLD4, str(d), str(d / "ckpt")), d, timeout=300)
    ranks2 = run_world(2, "_torch_lm_dist:sharded", (L.WORLD2, str(d)), d,
                       timeout=120)
    return ranks4, ranks2


@pytest.fixture(scope="module")
def reference(weights):
    out = {}
    for path, p in weights[1]:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
        out.update(L.read_reference(path))
    return out


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), (what, got, want)


def _masters(got: dict, want: dict, lr_sum: float, what: str) -> None:
    off = total = 0
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() < 2 * lr_sum, (what, name, d.max())
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= total // 1000, (what, off, total)


@pytest.mark.parametrize("name", sorted(L.CASES))
def test_sharded_step_matches_reference_and_one_device(name, weights,
                                                       worlds, reference):
    ranks = worlds[0] if name in L.WORLD4 else worlds[1]
    got = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["loss"] == got["loss"], name
        assert r[name]["grad_norm"] == got["grad_norm"], name
    lr_sum = L.STEPS * L.LR["lr"]             # the schedule's bound
    sides = {"reference": reference[name]}
    one = L.one_device(name, str(weights[0] / f"{name}.npz"))
    if name.endswith("overflow"):
        assert one["loss"][0] != got["loss"][0]      # tokens were dropped
    else:
        sides["one device"] = one
    for side, want in sides.items():
        for i in range(L.STEPS):
            _close(got["loss"][i], want["loss"][i], 1e-5, (side, "loss", i))
            _close(got["grad_norm"][i], want["grad_norm"][i], 1e-5,
                   (side, "grad_norm", i))
        _masters(got["master"], want["master"], lr_sum, side)
    # the MoE route each case exists for: the all-to-all, or none
    if name.startswith(("moe", "granite")):
        assert ("all_to_all" in got["traffic"]) == name.startswith("moe")


def test_backward_in_another_thread_keeps_the_mesh(worlds):
    """A CUDA backward runs on autograd's device thread, where the rules
    of the forward's thread are not set: the checkpointed blocks take
    them along, so the gradients there equal this thread's, bitwise."""
    assert all(r["backward_in_a_thread"] for r in worlds[1])


def test_one_rank_mesh_is_bitwise_one_device(tmp_path):
    cfg = L.config("qwen_tp_2x2")
    api = get_model(cfg, "cpu")
    b = [{k: torch.from_numpy(v) for k, v in x.items()}
         for x in L.batches(cfg, 32, 8)]
    with world1(tmp_path):
        mesh = ProcessMesh((1, 1), ("data", "model"))
        outs = []
        for m in (None, mesh):
            step, init = make_train_step(api, m, n_micro=2)
            state = init(0)
            for x in b:
                state, met = step(state, x)
            outs.append((state, met))
    (a, ma), (c, mc) = outs
    assert torch.equal(ma["loss"], mc["loss"])
    assert torch.equal(ma["grad_norm"], mc["grad_norm"])
    for part in ("master", "m", "v"):
        for (n, x), (_, y) in zip(tree_items(a["opt"][part]),
                                  tree_items(c["opt"][part])):
            assert torch.equal(x, y), part + n
    for (n, x), (_, y) in zip(tree_items(a["params"]),
                              tree_items(c["params"])):
        assert torch.equal(x, y), n


def test_train_lm_on_a_mesh_logs_once_and_resumes_on_one_device(weights,
                                                                worlds):
    """train_lm on (2, 2): only rank 0 logs; every rank has the same
    losses; its step-3 payload (the one-device layout) resumes on one
    device, whose steps 4-5 follow the sharded run's (bfloat16, so
    within 2e-2)."""
    ranks = [r["train_lm"] for r in worlds[0]]
    assert ranks[0]["step"] == [1, 2, 3, 4, 5]
    assert len(ranks[0]["lines"]) == 5 and all(
        not r["lines"] for r in ranks[1:])
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks[1:])
    ckpt = weights[0] / "ckpt"
    assert sorted(p.name for p in ckpt.glob("step_*.npz")) == [
        "step_00000003.npz"]
    lines = []
    hist = train_lm("qwen1.5-0.5b", **L.LAUNCH, device="cpu",
                    checkpoint_dir=str(ckpt), log_fn=lines.append)
    assert lines[0] == "[train] resuming from step 3"
    assert hist["step"] == [4, 5]
    for got, want in zip(hist["loss"], ranks[0]["loss"][3:]):
        _close(got, want, 2e-2, "loss after resume")


def _torchrun(ckpt: Path, steps: int) -> str:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "qwen1.5-0.5b", "--device", "cpu", "--steps",
           str(steps), "--seq-len", "16", "--global-batch", "4",
           "--checkpoint-dir", str(ckpt), "--checkpoint-every", "3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_launcher_trains_on_two_ranks_and_resumes_bitwise(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    out = _torchrun(a, 6)
    # rank 0 alone logs: the first step's line and the final loss
    assert out.count("[train] step=    1") == 1, out
    assert out.count("final loss") == 1, out
    assert sorted(p.name for p in a.glob("step_*.npz")) == [
        "step_00000003.npz", "step_00000006.npz"]
    b.mkdir()
    shutil.copy(a / "step_00000003.npz", b)
    out = _torchrun(b, 6)
    assert "resuming from step 3" in out
    with np.load(a / "step_00000006.npz") as x, \
            np.load(b / "step_00000006.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        assert any(k.startswith("master/") for k in x.files)
        for k in x.files:
            assert np.array_equal(x[k], y[k]), k


def test_refusals_name_what_waits():
    def small(arch, **over):
        return get_model(reduced_config(REGISTRY[arch], **over), "cpu")

    mesh = MeshShape((2, 2), ("data", "model"))
    for arch in ("mamba2-370m", "zamba2-1.2b", "minicpm3-4b",
                 "whisper-base"):
        with pytest.raises(NotImplementedError, match="#14c-2"):
            make_train_step(small(arch), mesh)
    # heads that do not divide the model axis: 4 on 8, and the published
    # deepseek-coder-33b's 56 on 16 (checked without building it)
    with pytest.raises(NotImplementedError, match="#14c-2"):
        make_train_step(small("qwen1.5-0.5b"),
                        MeshShape((1, 8), ("data", "model")))
    with pytest.raises(NotImplementedError, match="56 query"):
        make_train_step(get_model(REGISTRY["deepseek-coder-33b"], "cpu"),
                        MeshShape((1, 16), ("data", "model")))
    with pytest.raises(NotImplementedError, match="fsdp.*#14c-2"):
        make_train_step(small("qwen1.5-0.5b"), mesh, policy="fsdp")
    with pytest.raises(NotImplementedError, match="dp policy.*#14c-2"):
        make_train_step(small("deepseek-moe-16b"), mesh, policy="dp")
    for fn in (make_serve_step, make_prefill_step):
        with pytest.raises(NotImplementedError, match="#14c-2"):
            fn(small("qwen1.5-0.5b"), mesh)
    # a mesh to plan with is no mesh to train on
    with pytest.raises(TypeError, match="ProcessMesh"):
        make_train_step(small("qwen1.5-0.5b"), mesh)
