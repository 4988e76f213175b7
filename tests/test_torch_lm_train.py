"""The port's LM training and serving substrate against the reference's,
on the CPU: the synthetic data pipeline, AdamW and its schedule, the
accumulating train step, greedy decode through the serve step, and the
launcher's ``train_lm`` (its loss falls, its CLI runs, it refuses a
missing card, and its resume is bitwise the uninterrupted run where the
reference's resumes fresh weights).

Tolerances: data bitwise; ``lr_at`` within 1e-7; ``adamw_update``'s
master, m and v within rtol 1e-6 and its grad norm within 1e-6; a train
step (float32) within 1e-5 on the loss, 1e-4 on the grad norm and atol
1e-6 on the new master; greedy tokens equal but at near-ties (a top-2
gap below 1e-4 in the reference's logits, at most one in the run); the
port's resume bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.data.synthetic import make_batch as jmake_batch
from repro.models.registry import get_model as jget_model
from repro.models.registry import reduced_config as jreduced
from repro.runtime.compat import make_mesh
from repro.train import optimizer as jopt
from repro.train.serve_step import make_serve_step as jmake_serve_step
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import REGISTRY
from repro_torch.data.synthetic import SyntheticLM, make_batch
from repro_torch.launch.train import main as launch_main
from repro_torch.launch.train import train_lm
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import get_model, reduced_config
from repro_torch.models.tree import tree_items
from repro_torch.train import optimizer as opt
from repro_torch.train.serve_step import make_serve_step
from repro_torch.train.train_step import default_microbatches, make_train_step

def t(x):
    return torch.from_numpy(np.array(x))


def small(arch="qwen1.5-0.5b", **over):
    """(jax cfg, port cfg): a two-layer float32 model of the family."""
    jcfg = dataclasses.replace(
        jreduced(JREGISTRY[arch], n_layers=2, d_model=64, **over),
        param_dtype="float32")
    return jcfg, dataclasses.replace(REGISTRY[arch],
                                     **dataclasses.asdict(jcfg))


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_synthetic_lm_bitwise(seed, step):
    a = SyntheticLM(1000, seed=seed).batch(step, 4, 33)
    b = JSyntheticLM(1000, seed=seed).batch(step, 4, 33)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "pixtral-12b",
                                  "whisper-base"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_bitwise(arch, kind):
    for seed, step in ((0, 0), (5, 3)):
        got = make_batch(reduced_config(REGISTRY[arch]), 48, 4, kind,
                         step=step, seed=seed)
        want = jmake_batch(jreduced(JREGISTRY[arch]), 48, 4, kind,
                           step=step, seed=seed)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (arch, kind, k)


# -- optimizer -----------------------------------------------------------------

def test_lr_schedule_matches_reference():
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 5, 10, 50, 100):
        got = float(opt.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - float(jopt.lr_at(jcfg, jnp.int32(s)))) < 1e-7, s
        assert float(opt.lr_at(cfg, s)) == got


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(param_dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (5, 7), "b": (7,)}, "c": (3, 4, 2)}

    def tree(scale):
        return jax.tree.map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    params, grads = tree(1.0), tree(3.0)        # norm > 1: clipped
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jstate = jopt.init_opt_state(jax.tree.map(jnp.asarray, params))
    state = opt.init_opt_state(params_from_reference(params, device="cpu"))
    for _ in range(3):
        jp, jstate, jm = jopt.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, grads), jstate,
            param_dtype=jnp.dtype(param_dtype))
        p, state, m = opt.adamw_update(
            cfg, params_from_reference(grads, device="cpu"), state,
            param_dtype=param_dtype)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) < 1e-6
        assert abs(float(m["lr"]) - float(jm["lr"])) < 1e-9
        assert int(state["count"]) == int(jstate["count"])
        for part in ("master", "m", "v"):
            want = dict(tree_items(jax.tree.map(np.asarray, jstate[part])))
            for name, x in tree_items(state[part]):
                np.testing.assert_allclose(x.numpy(), want[name], rtol=1e-6,
                                           atol=1e-9, err_msg=part + name)
        for name, x in tree_items(p):
            assert x.dtype == getattr(torch, param_dtype)
            assert torch.equal(x, dict(tree_items(state["master"]))[name]
                               .to(x.dtype))
        grads = tree(0.1)                        # under the clip


def test_adamw_descends_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_opt_state(params)
    for _ in range(100):
        params, state, metrics = opt.adamw_update(
            cfg, {"w": params["w"]}, state, param_dtype=torch.float32)
    assert float(params["w"].abs().max()) < 0.2


# -- train step ----------------------------------------------------------------

def _reference_and_port_steps(n_micro, rs_per_micro, eps, n_steps=2):
    jcfg, cfg = small()
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10, eps=eps)
    jocfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10,
                             eps=eps)
    jstep, jinit = jmake_train_step(jget_model(jcfg), make_mesh(
        (1, 1), ("data", "model")), n_micro=n_micro, opt_cfg=jocfg,
        rs_per_micro=rs_per_micro)
    jstate = jinit(jax.random.PRNGKey(0))
    step, _ = make_train_step(get_model(cfg, "cpu"), n_micro=n_micro,
                              opt_cfg=ocfg, rs_per_micro=rs_per_micro)
    params = params_from_reference(jax.tree.map(np.asarray,
                                                 jstate["params"]), cfg, "cpu")
    state = {"params": params, "opt": opt.init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jstep)
    out = []
    for i in range(n_steps):
        batch = make_batch(cfg, 24, 4, "train", step=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: t(v) for k, v in batch.items()})
        out.append((jstate, jm, state, m))
    return out


@pytest.mark.parametrize("rs_per_micro,eps", [(True, 1e-3), (False, 1e-8)])
def test_train_steps_match_reference(rs_per_micro, eps):
    """Two steps with n_micro 2 against the reference's on a (1, 1) mesh.

    With eps = 1e-3 AdamW's map from gradient to update is smooth and
    every new master weight agrees within atol 1e-6. With the default
    eps = 1e-8 the first steps move a weight by about ±lr by its
    gradient's sign, and a gradient at the rounding floor (the key bias's
    is zero in exact arithmetic: softmax is shift-invariant along keys)
    may take either sign in either package: at most 0.1% of the weights
    may then differ by more than 1e-6, each by less than the two steps'
    2·Σlr.
    """
    lr_sum = 0.0
    for jstate, jm, state, m in _reference_and_port_steps(2, rs_per_micro,
                                                          eps):
        lr_sum += float(jm["lr"])
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
        want = dict(tree_items(jax.tree.map(np.asarray,
                                            jstate["opt"]["master"])))
        off = total = 0
        for name, x in tree_items(state["opt"]["master"]):
            d = np.abs(x.numpy() - want[name])
            assert d.max() < 2 * lr_sum, name
            off += int((d > 1e-6).sum())
            total += d.size
        assert off == 0 if eps == 1e-3 else off <= total // 1000, off
        assert int(state["step"]) == int(jstate["step"])


def test_microbatching_is_loss_equivalent():
    """As tests/test_train.py:143: n_micro 1 and 4 give the same step-0
    loss and (nearly) the same gradient norm."""
    _, cfg = small()
    batch = {k: t(v) for k, v in make_batch(cfg, 32, 8, "train").items()}
    outs = {}
    for n_micro in (1, 4):
        step, init = make_train_step(get_model(cfg, "cpu"), n_micro=n_micro)
        _, m = step(init(0), batch)
        outs[n_micro] = (float(m["loss"]), float(m["grad_norm"]))
    assert abs(outs[1][0] - outs[4][0]) < 1e-3, outs
    assert abs(outs[1][1] - outs[4][1]) / outs[1][1] < 2e-2, outs


def test_default_microbatches_and_meshes():
    from repro_torch.configs import SHAPES
    shape = SHAPES["train_4k"]
    for arch in ("qwen1.5-0.5b", "internlm2-20b", "deepseek-coder-33b"):
        cfg = REGISTRY[arch]
        n = default_microbatches(cfg, shape)
        assert shape.global_batch % n == 0
    assert default_microbatches(REGISTRY["qwen1.5-0.5b"], shape) == 32

    class Mesh:
        shape = {"data": 2, "model": 2}

    # the sharded step needs a ProcessMesh (tests/test_torch_lm_sharded.py
    # runs it); sharded decode waits for #14c-2
    with pytest.raises(TypeError, match="ProcessMesh"):
        make_train_step(get_model(small()[1], "cpu"), Mesh())
    with pytest.raises(NotImplementedError, match="#14c-2"):
        make_serve_step(get_model(small()[1], "cpu"), Mesh())
    assert default_microbatches(REGISTRY["qwen1.5-0.5b"], shape, Mesh()) == 16


# -- serving -------------------------------------------------------------------

def test_greedy_serve_tokens_match_reference():
    """8 greedy tokens through both serve steps, the reference's token fed
    to both at each step; a differing argmax is allowed only at a near-tie
    of the reference's logits, and at most once."""
    jcfg, cfg = small(vocab_size=128, vocab_pad_multiple=64)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = get_model(cfg, "cpu")
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    jserve = jax.jit(jmake_serve_step(japi, make_mesh((1, 1),
                                                      ("data", "model"))))
    serve = make_serve_step(api)
    jcache, cache = japi.make_cache(4, 16), api.make_cache(4, 16)
    toks = np.zeros((4, 1), np.int32)
    ties = 0
    for _ in range(8):
        jlogits, jcache = jserve(jparams, jcache, jnp.asarray(toks))
        logits, cache = serve(params, cache, t(toks))
        want = np.asarray(jlogits)
        got = logits.argmax(-1).numpy()
        top2 = np.sort(want, axis=-1)[:, -2:]
        for b in np.nonzero(got != want.argmax(-1))[0]:
            assert top2[b, 1] - top2[b, 0] < 1e-4
            ties += 1
        toks = want.argmax(-1).astype(np.int32)[:, None]
    assert ties <= 1
    assert int(cache["length"]) == int(jcache["length"]) == 8
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()


# -- the launcher --------------------------------------------------------------

def test_train_lm_loss_falls_on_the_cpu():
    hist = train_lm("qwen1.5-0.5b", steps=30, seq_len=32, global_batch=4,
                    log_every=5, device="cpu", log_fn=lambda _: None)
    assert hist["step"] == [1, 5, 10, 15, 20, 25, 30]
    assert np.isfinite(hist["loss"]).all()
    assert hist["loss"][-1] < hist["loss"][0] - 0.3, hist["loss"]
    assert all(x > 0 for x in hist["tokens_per_sec"])
    assert int(hist["state"]["step"]) == 30


def test_cli_trains_the_lm_on_the_cpu(capsys):
    assert launch_main(["--arch", "qwen1.5-0.5b", "--device", "cpu",
                        "--steps", "3", "--seq-len", "16",
                        "--global-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] step=    1" in out and "final loss" in out


def test_cli_refuses_families_not_ported(monkeypatch, capsys):
    """Every config of the registry trains through the CLI now (the MoE
    one here); what the reference lacks is still refused: an --arch
    outside the registry, and a config whose attention kind the
    reference does not have. (The name is the one this test had while
    five families were refused; it is kept so that the test's record
    runs on unbroken.)"""
    assert launch_main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                        "--steps", "1", "--seq-len", "16",
                        "--global-batch", "2"]) == 0
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_main(["--arch", "no-such-model", "--device", "cpu"])
    import repro_torch.launch.train as launch
    monkeypatch.setitem(launch.REGISTRY, "qwen1.5-0.5b", dataclasses.replace(
        REGISTRY["qwen1.5-0.5b"], attn_kind="sliding"))
    with pytest.raises(NotImplementedError, match="attn_kind='sliding'"):
        launch_main(["--arch", "qwen1.5-0.5b", "--device", "cpu",
                     "--steps", "1"])


def test_no_card_means_no_quiet_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm("qwen1.5-0.5b", steps=1, log_fn=lambda _: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(small()[1])


class _Stop(Exception):
    pass


def test_train_lm_resume_is_bitwise(tmp_path):
    """A 60-step run killed at step 55 (after its step-50 save) and run
    again in the same directory ends bitwise the uninterrupted run."""
    kw = dict(steps=60, seq_len=16, global_batch=2, log_every=5,
              device="cpu")
    full = train_lm("qwen1.5-0.5b", **kw, log_fn=lambda _: None)

    def killer(line):
        if line.startswith("[train] step=   55"):
            raise _Stop

    with pytest.raises(_Stop):
        train_lm("qwen1.5-0.5b", **kw, checkpoint_dir=str(tmp_path),
                 log_fn=killer)
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == [
        "step_00000050.npz"]
    lines = []
    resumed = train_lm("qwen1.5-0.5b", **kw, checkpoint_dir=str(tmp_path),
                       log_fn=lines.append)
    assert lines[0] == "[train] resuming from step 50"
    assert resumed["step"] == [51, 55, 60]
    i = full["step"].index(55)
    assert resumed["loss"][1:] == full["loss"][i:]
    a, b = full["state"], resumed["state"]
    for part in ("params", "master", "m", "v"):
        x_tree = a[part] if part == "params" else a["opt"][part]
        y_tree = b[part] if part == "params" else b["opt"][part]
        for (n, x), (_, y) in zip(tree_items(x_tree), tree_items(y_tree)):
            assert x.dtype == y.dtype and torch.equal(x, y), part + n
    assert int(a["opt"]["count"]) == int(b["opt"]["count"]) == 60
    assert int(a["step"]) == int(b["step"]) == 60


def test_resume_refuses_a_payload_without_train_state(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    CheckpointManager(str(tmp_path)).save(50, {"step": np.int64(50)})
    with pytest.raises(ValueError, match="no train state"):
        train_lm("qwen1.5-0.5b", steps=60, seq_len=16, global_batch=2,
                 device="cpu", checkpoint_dir=str(tmp_path),
                 log_fn=lambda _: None)


def test_reference_checkpoint_holds_only_the_step(tmp_path):
    """The reference fault the port leaves out: the reference's train_lm
    saves only {"step"} (src/repro/launch/train.py:115) and restarts from
    fresh weights (:92, :97)."""
    from repro.launch.train import train_lm as jtrain_lm
    jtrain_lm("qwen1.5-0.5b", steps=50, seq_len=16, global_batch=2,
              checkpoint_dir=str(tmp_path), log_every=50,
              log_fn=lambda _: None)
    files = sorted(tmp_path.glob("step_*.npz"))
    assert [p.name for p in files] == ["step_00000050.npz"]
    with np.load(files[0]) as z:
        keys = set(z.files)
    assert keys - {"__checksum__"} == {"step"}
