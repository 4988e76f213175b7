"""The port's partition rules against the reference's, entry for entry:
``param_specs`` and ``zero1_specs`` under every policy for every config
of the registry, at the published size and at ``reduced_config``, on
meshes up to 2 × 16 × 16; ``cache_specs`` on every family's cache;
``safe_spec`` and ``LogicalRules`` on drawn dims and wanted axes.

No device is forged and nothing is allocated: the reference's shapes
come from ``jax.eval_shape`` and its meshes are
``jax.sharding.AbstractMesh`` (the rules read only ``mesh.shape``); the
port's shapes are meta-device trees (``param_shapes``) and its meshes
``MeshShape``. Also the reference's own assertions
(``tests/test_train.py``): deepseek-coder-33b's big matmuls shard on a
(1, 16) mesh, and qwen1.5-0.5b's ZeRO-1 specs shard over the data axis
on more than half its leaves on (4, 2).
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from _hyp import given, settings, st
from repro.configs import REGISTRY as JREGISTRY
from repro.models.registry import get_model as jget_model
from repro.models.registry import reduced_config as jreduced
from repro.runtime import sharding as jsharding
from repro.train import partition as jpartition
from repro_torch.configs import REGISTRY
from repro_torch.launch.mesh import (make_production_mesh,
                                     production_mesh_shape)
from repro_torch.models import encdec, transformer
from repro_torch.models.registry import param_shapes, reduced_config
from repro_torch.models.tree import tree_items
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import MeshShape
from repro_torch.train import partition
from repro_torch.train.train_step import train_state_specs

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((1, 16), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
POLICIES = ("tp", "dp", "ep", "fsdp")


def jspecs(tree) -> dict:
    """A reference tree of PartitionSpec (or shapes) by path."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jpartition._path_str(p): (tuple(x) if isinstance(x, JP)
                                      else tuple(x.shape))
            for p, x in flat}


def pspecs(tree) -> dict:
    return {p: tuple(x) if isinstance(x, tuple) else tuple(x.shape)
            for p, x in tree_items(tree)}


def both_shapes(arch: str, reduced: bool):
    jcfg, cfg = JREGISTRY[arch], REGISTRY[arch]
    if reduced:
        jcfg, cfg = jreduced(jcfg), reduced_config(cfg)
    jshape = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    return jshape, param_shapes(cfg)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_and_zero1_specs_match_reference(arch):
    for reduced in (False, True):
        jshape, shape = both_shapes(arch, reduced)
        assert pspecs(shape) == jspecs(jshape), (arch, reduced)
        for dims, names in MESHES:
            jmesh, mesh = AbstractMesh(dims, names), MeshShape(dims, names)
            for policy in POLICIES:
                for fn in ("param_specs", "zero1_specs"):
                    got = pspecs(getattr(partition, fn)(mesh, shape, policy))
                    want = jspecs(getattr(jpartition, fn)(jmesh, jshape,
                                                          policy))
                    assert got == want, (arch, reduced, dims, policy, fn)


def _caches(arch: str):
    """(reference cache shapes, port meta cache) of a config at B, L."""
    jcfg, cfg = JREGISTRY[arch], REGISTRY[arch]
    japi = jget_model(jcfg)
    meta = torch.device("meta")
    for b, length in ((1, 4096), (16, 4096), (3, 100)):
        jc = jax.eval_shape(lambda: japi.make_cache(b, length))
        if cfg.is_encoder_decoder:
            c = encdec.init_encdec_cache(cfg, b, length, length, meta)
        else:
            c = transformer.init_cache(cfg, b, length, meta)
        yield b, jc, c


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_specs_match_reference(arch):
    for b, jc, c in _caches(arch):
        assert pspecs(c) == jspecs(jc), (arch, b)
        for dims, names in MESHES:
            got = pspecs(partition.cache_specs(MeshShape(dims, names), c))
            want = jspecs(jpartition.cache_specs(AbstractMesh(dims, names),
                                                 jc))
            assert got == want, (arch, b, dims)


AXES = [None, "data", "model", "pod", ("data", "model"), ("model", "data"),
        ("pod", "data"), ("pod", "data", "model")]


@settings(max_examples=300, deadline=None)
@given(dims=st.lists(st.integers(1, 96), min_size=1, max_size=4),
       picks=st.lists(st.integers(0, len(AXES) - 1), min_size=4,
                      max_size=4),
       mesh=st.sampled_from(MESHES + [((3, 4), ("data", "model")),
                                      ((2, 3, 4), ("pod", "data",
                                                   "model"))]))
def test_safe_spec_matches_reference(dims, picks, mesh):
    shape, names = mesh
    # axes this mesh lacks are not wanted (both packages would raise)
    wanted = [None if w is not None and any(
        a not in names for a in ((w,) if isinstance(w, str) else w))
        else w for w in (AXES[i] for i in picks[:len(dims)])]
    got = sharding.safe_spec(MeshShape(shape, names), dims, wanted)
    want = jsharding.safe_spec(AbstractMesh(shape, names), dims, wanted)
    assert tuple(got) == tuple(want), (dims, wanted, shape)


@pytest.mark.parametrize("policy", POLICIES)
def test_logical_rules_match_reference(policy):
    logical = [("batch", "seq", "heads", None), ("batch", "seq_tp", "embed"),
               ("batch", "kv_seq", "kv_heads", None), ("experts", None),
               ("batch", None, "vocab"), ("batch", "seq", "ffn")]
    for dims, names in MESHES:
        rules = sharding.LogicalRules(MeshShape(dims, names), policy=policy)
        jrules = jsharding.LogicalRules(AbstractMesh(dims, names),
                                        policy=policy)
        assert rules.table == jrules.table
        for shape in ((32, 4096, 16, 128), (1, 56, 7168), (6, 256, 8, 64),
                      (64, 4), (16, 1024, 151936), (4, 33, 1408)):
            for lg in logical:
                if len(lg) != len(shape):
                    continue
                assert tuple(rules.spec(shape, lg)) == tuple(
                    jrules.spec(shape, lg)), (dims, policy, shape, lg)


def test_reference_assertions_hold_on_the_port():
    """tests/test_train.py's: on (1, 16) deepseek-coder-33b's big matmuls
    shard over model; on (4, 2) qwen1.5-0.5b's ZeRO-1 specs shard over
    data on more than half its leaves."""
    sp = dict(tree_items(partition.param_specs(
        MeshShape((1, 16), ("data", "model")),
        param_shapes(REGISTRY["deepseek-coder-33b"]))))
    assert sp["embed/table"][0] == "model", sp["embed/table"]
    assert sp["blocks/attn/wq/w"][2] == "model"
    assert sp["blocks/mlp/w_gate"][2] == "model"
    assert sp["blocks/mlp/w_down"][1] == "model"
    z = [s for _, s in tree_items(partition.zero1_specs(
        MeshShape((4, 2), ("data", "model")),
        param_shapes(REGISTRY["qwen1.5-0.5b"])))]
    n = sum(any(e == "data" or (isinstance(e, tuple) and "data" in e)
                for e in s) for s in z)
    assert n > len(z) * 0.5, n


def test_train_state_specs_layout():
    shape = param_shapes(reduced_config(REGISTRY["qwen1.5-0.5b"]))
    mesh = MeshShape((2, 2), ("data", "model"))
    specs = train_state_specs(mesh, shape)
    z = partition.zero1_specs(mesh, shape)
    assert specs["params"] == partition.param_specs(mesh, shape)
    assert specs["opt"]["master"] == specs["opt"]["m"] == z
    assert tuple(specs["step"]) == tuple(specs["opt"]["count"]) == ()


def test_production_mesh_shapes_and_refusal():
    assert production_mesh_shape().shape == {"data": 16, "model": 16}
    assert production_mesh_shape(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
