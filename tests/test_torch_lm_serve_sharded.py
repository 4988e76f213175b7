"""The port's sharded decode and prefill against the reference's and
against its own one-device steps, on the CPU.

Gloo worlds of 4 and 2 spawned processes (``tests/_torch_dist.py::
run_world``) serve the cases of ``tests/_torch_lm_dist.py::SERVE``, each
a reduced float32 config of one family: qwen1.5-0.5b (dense) on (2, 2),
(1, 4) and (2, 1), at batch 1 on (2, 2) (the KV heads over the data
axis); deepseek-moe-16b (MoE: decode's one position takes the
replicated-activation route); minicpm3-4b (MLA); mamba2-370m (SSM: the
state's heads over ``model``); zamba2-1.2b (hybrid: the shared block's
KV slots, at batch 1); whisper-base (encoder-decoder) with 33 frames on
(2, 2), which do not divide the model axis, and 32 on (1, 2). Each rank
holds its blocks of the params (``zero1_specs``, gathered over the data
axes a layer at a time) and of the cache (``cache_specs``); twelve
tokens decode past the first rank's sequence block, and on (1, 4) past
the cache's last slot. The reference's ``make_serve_step`` and
``make_prefill_step`` run the same cases jitted on forged CPU devices
(``runtime/compat.make_mesh``) under ``serve_state_shardings``, in a
subprocess started first.

Tolerances: every rank gathers the same logits, bitwise; decode and
prefill logits within rtol/atol 1e-5 of the reference's sharded step
and of the port's one-device step (the flash-decode's combine reorders
the softmax's sums). whisper's reference decode never sees the encoder,
so it is compared on the zero cross cache; the filled cache is compared
with the one-device port. Past the cache's last slot the reference's
sharded step leaves its own one-device step (pinned below); the port's
sharded step follows the one-device one there, in both packages.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_lm_dist as L
from _torch_dist import run_world
from repro_torch.models.registry import cache_shapes
from repro_torch.runtime.sharding import MeshShape
from repro_torch.train.partition import cache_specs
from repro_torch.models.tree import tree_items

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Every case's weights and inputs, and the reference's run started
    on them."""
    d = tmp_path_factory.mktemp("lm_serve_sharded")
    for name in L.SERVE:
        L.save_serve_weights(name, d / f"{name}.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", L.REFERENCE_SERVE,
         L.reference_serve_args(list(L.SERVE), d), str(d),
         str(d / "ref.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def worlds(weights):
    d, _ = weights
    ranks4 = run_world(4, "_torch_lm_dist:serve", (L.SERVE4, str(d)), d,
                       timeout=300)
    ranks2 = run_world(2, "_torch_lm_dist:serve", (L.SERVE2, str(d)), d,
                       timeout=200)
    return {name: (ranks4 if name in L.SERVE4 else ranks2)
            for name in L.SERVE}


@pytest.fixture(scope="module")
def reference(weights):
    d, proc = weights
    _, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-3000:]
    return L.read_reference_serve(d / "ref.npz")


def _in_cache(name: str) -> int:
    """The decode steps whose position lies inside the cache."""
    return min(L.SERVE[name][5], L.SERVE[name][4])


@pytest.mark.parametrize("name", sorted(L.SERVE))
def test_sharded_serving_matches_reference_and_one_device(
        name, weights, worlds, reference):
    ranks = worlds[name]
    got = ranks[0][name]
    keys = [k for k in ("decode", "prefill", "decode_filled") if k in got]
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(r[name][k], got[k]), (name, k)
    one = L.serve_one_device(name, str(weights[0] / f"{name}.npz"))
    for k in keys:
        np.testing.assert_allclose(got[k], one[k], **TOL,
                                   err_msg=f"{name} {k} vs one device")
    ref = reference[name]
    n = _in_cache(name)
    np.testing.assert_allclose(got["decode"][:n], ref["decode"][:n], **TOL,
                               err_msg=f"{name} decode vs reference")
    np.testing.assert_allclose(got["prefill"], ref["prefill"], **TOL,
                               err_msg=f"{name} prefill vs reference")
    if "decode_one" in ref:          # past the last slot: one device's
        np.testing.assert_allclose(got["decode"][n:], ref["decode_one"][n:],
                                   **TOL)
    # the decode combined partials over model wherever the sequence is
    # split (an all-reduce beside the gathers)
    assert got["traffic"]["all_gather"][0] > 0


def test_reference_sharded_decode_leaves_its_one_device_past_the_cache(
        reference):
    """Past the last slot both packages clamp the write to slot S-1. The
    reference's sharded step (sequence over model) then leaves its own
    one-device step by up to 0.2 a logit; the port's sharded step keeps
    to the one-device one (the test above)."""
    name = "qwen_serve_1x4"
    ref = reference[name]
    n = _in_cache(name)
    np.testing.assert_allclose(ref["decode"][:n], ref["decode_one"][:n],
                               **TOL)
    assert np.abs(ref["decode"][n:] - ref["decode_one"][n:]).max() > 1e-2


@pytest.mark.parametrize("name", sorted(L.SERVE))
def test_cache_blocks_follow_cache_specs(name, worlds):
    """Each rank's cache blocks are its blocks of ``cache_specs``: the
    sequence over model, the batch over data, at batch 1 the KV heads
    over data; an encoder length that does not divide model keeps the
    cross cache whole."""
    _, _, shape, batch, max_len, _, enc_len, _ = L.SERVE[name]
    mesh = MeshShape(shape, ("data", "model"))
    full = cache_shapes(L.serve_config(name), batch, max_len, enc_len)
    specs = dict(tree_items(cache_specs(mesh, full)))
    for path, t in tree_items(full):
        spec = tuple(specs[path]) + (None,) * t.ndim
        want = tuple(d // int(np.prod([mesh.shape[a] for a in
                                       ((e,) if isinstance(e, str)
                                        else e or ())]))
                     for d, e in zip(t.shape, spec))
        assert worlds[name][0][name]["cache"][path] == want, (path, spec)
    if name == "qwen_serve_2x2_b1":
        assert specs["k"] == (None, None, "model", "data", None)
    if name == "whisper_serve_2x2":
        assert specs["x_k"][2] is None and specs["k"][2] == "model"
