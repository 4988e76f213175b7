"""The port's sharded LM where the reference's layouts split a head or
reshard the rows, against the port's one-device step, on the CPU.

Cases (``tests/_torch_lm_dist.py::HEADS_CASES``, reduced float32, two
steps each from the same weights and batches):

* heads that do not divide the model axis, tensor-parallel on (1, 4):
  6 query heads (a head's columns on two ranks) with a sequence of 32,
  sequence-parallel attention, and of 33, where every rank runs the
  whole attention; 4 query heads over 2 KV heads (each rank's query
  head reads half a group); MLA with 6 heads;
* the dp and fsdp policies' MoE on (2, 2): the rows resharded to the
  data shard's, the all-to-all route (seq 32) and replicated-activation
  (seq 33), at a capacity that drops nothing; and the dp policy at the
  default capacity, where each rank's capacity drops tokens, held to the
  reference's sharded step alone;
* 64 expert stacks on a model axis of 3 (a world of 3): the dispatch of
  the global batch, under tp and under dp, where 6 rows of 768 drop
  tokens at the default capacity and the rows are gathered.

One world of 4 and one of 3 (``tests/_torch_dist.py::run_world``) run
them, and the world of 4 also decodes ten tokens and prefills for the
three head layouts (``HEADS_SERVE``). Tolerances: every rank reports
the same metrics; loss and grad norm within 1e-5 relative of the
one-device step; at most 0.1% of the final masters differ by more than
1e-6; decode and prefill logits within 1e-5 of the largest one-device
logit. The 6-head case also runs through the reference's sharded step
on forged devices (``REFERENCE``; one run compiles it and the dropping
dp case) and is held to it the same way. AdamW's eps is the default but
for ``moe_dp_2x2_seq33`` (``_torch_lm_dist.SMOOTH`` gives the drift).
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_lm_dist as L
from _torch_dist import run_world
from repro_torch.configs import REGISTRY
from repro_torch.models.transformer import check_sharded
from repro_torch.runtime.sharding import MeshShape

ROOT = Path(__file__).resolve().parents[1]
REF_CASE = "heads6_tp_1x4"
# held to the reference's sharded step only: it drops tokens by each
# rank's capacity, where the one-device step drops others
DROP_CASE = "moe_dp_2x2_drop"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Every case's weights, and the reference's run of REF_CASE started
    on them."""
    d = tmp_path_factory.mktemp("lm_sharded_heads")
    for name in L.HEADS_CASES:
        L.save_weights(name, d / f"{name}.npz")
    for name in L.HEADS_SERVE:
        L.save_serve_weights(name, d / f"{name}.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", L.REFERENCE,
         L.reference_args([REF_CASE, DROP_CASE]),
         str(d), str(d / "ref.npz")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def worlds(weights):
    d, _ = weights
    ranks4 = run_world(4, "_torch_lm_dist:heads",
                       (L.HEADS4, list(L.HEADS_SERVE), str(d)), d,
                       timeout=300)
    ranks3 = run_world(3, "_torch_lm_dist:heads", (L.HEADS3, [], str(d)), d,
                       timeout=300)
    return ranks4, ranks3


@pytest.fixture(scope="module")
def reference(weights):
    path, proc = weights[0] / "ref.npz", weights[1]
    _, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-3000:]
    return L.read_reference(path)


@contextlib.contextmanager
def _one_thread():
    """The one-device step on one thread, as each gloo rank runs it: under
    xdist the workers share the cores, where a step on all of them spins
    for its turn."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), (what, got, want)


def _masters(got: dict, want: dict, what: str) -> None:
    off = total = 0
    for name, w in want.items():
        d = np.abs(got[name] - w)
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= total // 1000, (what, off, total)


# the collective each case's layout or route exists for, and one it
# must not use
ROUTES = {
    "heads6_tp_1x4": ("all_to_all", None),
    "heads6_tp_1x4_seq33": ("all_gather", "all_to_all"),
    "kv2_tp_1x4": ("reduce_scatter", "all_to_all"),
    "mla6_tp_1x4": ("all_to_all", None),
    "moe_dp_2x2": ("all_to_all", None),
    "moe_fsdp_2x2": ("all_to_all", None),
    "moe_dp_2x2_seq33": ("reduce_scatter", None),
    "moe64_tp_1x3": (None, "all_to_all"),
    "moe64_dp_1x3": ("all_gather", "all_to_all"),
    "moe_dp_2x2_drop": ("all_to_all", None),
}


@pytest.mark.parametrize("name", sorted(set(L.HEADS_CASES) - {DROP_CASE}))
def test_step_matches_one_device(name, weights, worlds):
    ranks = worlds[0] if name in L.HEADS4 else worlds[1]
    got = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["loss"] == got["loss"], name
        assert r[name]["grad_norm"] == got["grad_norm"], name
    with _one_thread():
        want = L.one_device(name, str(weights[0] / f"{name}.npz"))
    for i in range(L.STEPS):
        _close(got["loss"][i], want["loss"][i], 1e-5, ("loss", i))
        _close(got["grad_norm"][i], want["grad_norm"][i], 1e-5,
               ("grad_norm", i))
    _masters(got["master"], want["master"], name)
    used, unused = ROUTES[name]
    assert used is None or used in got["traffic"], (name, got["traffic"])
    assert unused not in got["traffic"], (name, got["traffic"])


def test_uneven_heads_match_the_reference(worlds, reference):
    got, want = worlds[0][0][REF_CASE], reference[REF_CASE]
    for i in range(L.STEPS):
        _close(got["loss"][i], want["loss"][i], 1e-5, ("loss", i))
        _close(got["grad_norm"][i], want["grad_norm"][i], 1e-5,
               ("grad_norm", i))
    _masters(got["master"], want["master"], "reference")


def test_dp_moe_at_the_default_capacity_matches_the_reference(worlds,
                                                             reference):
    """The dp policy's MoE where the rank's capacity drops tokens: every
    rank the same metrics, and the step the reference's sharded one."""
    ranks = worlds[0]
    got, want = ranks[0][DROP_CASE], reference[DROP_CASE]
    for r in ranks[1:]:
        assert r[DROP_CASE]["loss"] == got["loss"]
        assert r[DROP_CASE]["grad_norm"] == got["grad_norm"]
    for i in range(L.STEPS):
        _close(got["loss"][i], want["loss"][i], 1e-5, ("loss", i))
        _close(got["grad_norm"][i], want["grad_norm"][i], 1e-5,
               ("grad_norm", i))
    _masters(got["master"], want["master"], DROP_CASE)
    used, unused = ROUTES[DROP_CASE]
    assert used in got["traffic"] and unused not in got["traffic"]


@pytest.mark.parametrize("name", sorted(L.HEADS_SERVE))
def test_decode_and_prefill_match_one_device(name, weights, worlds):
    with _one_thread():
        want = L.serve_one_device(name, str(weights[0] / f"{name}.npz"))
    for rank, r in enumerate(worlds[0]):
        for what in ("decode", "prefill"):
            g, w = r[name][what], want[what]
            assert g.shape == w.shape, (what, rank)
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= 1e-5, (name, what, rank, err)


def test_only_what_the_reference_refuses_is_refused():
    """Every published config passes ``check_sharded`` on the production
    16 × 16 mesh under every policy (56, 24 and 40 query heads, 8 KV
    heads, whisper's 8 heads, 40 and 64 experts on 16); a policy
    outside the reference's ``--policy`` choices is refused."""
    mesh = MeshShape((16, 16), ("data", "model"))
    for cfg in REGISTRY.values():
        for policy in ("tp", "dp", "ep", "fsdp"):
            check_sharded(cfg, mesh, policy)
    with pytest.raises(ValueError, match="--policy choices"):
        check_sharded(REGISTRY["qwen1.5-0.5b"], mesh, "zero3")
