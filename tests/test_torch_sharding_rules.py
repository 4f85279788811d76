"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's, with no world: abstract meshes of the reference's
production shapes, (data 16, model 16) and (pod 2, data 16, model 16).

Exact: every parameter leaf's spec for all ten registered archs at full
size (the port's tree on the meta device, the reference's from
``jax.eval_shape``), ``batch_spec`` for every ``INPUT_SHAPES`` entry, and
``cache_specs`` for the decode shapes, each spec the tuple of the
reference's ``PartitionSpec``.  Also what ``tests/test_sharding.py``
means to check (that module fails to build its meshes on the installed
JAX): every sharded dimension divides by its axes' size.  And the
placements ``named`` gives, and the shard cutter of ``convert.py``,
whose shards put back together give the full arrays.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.models import api as japi
from repro.sharding import rules as jrules
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import local_shards_from_numpy
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import api as tapi
from repro_torch.sharding import rules
from repro_torch.sharding.context import AbstractMesh as TAbstractMesh

MESHES = {"1pod": (AbstractMesh((16, 16), ("data", "model")),
                   production_mesh_shape(False)),
          "2pod": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                   production_mesh_shape(True))}
DECODE = [name for name, s in INPUT_SHAPES.items() if s.kind == "decode"]


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jrules._path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree, path=()) -> dict:
    if rules.is_spec(tree):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    return {p: s for k, v in items
            for p, s in _port_specs(v, path + (str(k),)).items()}


def _shapes(tree, path=()) -> dict:
    if isinstance(tree, torch.Tensor):
        return {"/".join(path): tuple(tree.shape)}
    items = (tree.items() if isinstance(tree, dict) else zip(tree._fields,
                                                             tree))
    return {p: s for k, v in items
            for p, s in _shapes(v, path + (str(k),)).items()}


def _assert_divides(specs: dict, shapes: dict, mesh) -> None:
    assert set(specs) == set(shapes)
    for path, spec in specs.items():
        shape = shapes[path]
        assert len(spec) <= len(shape), path
        for dim, ax in zip(shape, spec):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            assert dim % int(np.prod([mesh.shape[a] for a in axes])) == 0, \
                (path, shape, spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh):
    jmesh, tmesh = MESHES[mesh]
    shapes = jax.eval_shape(lambda: japi.init_params(jax.random.key(0),
                                                     JARCHS[arch]))
    want = _jax_specs(jrules.param_specs(shapes, JARCHS[arch], jmesh))
    got = _port_specs(rules.param_specs(tapi.init_params(ARCHS[arch]),
                                        ARCHS[arch], tmesh))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_divide_their_leaves(arch, mesh):
    tmesh = MESHES[mesh][1]
    params = tapi.init_params(ARCHS[arch])
    _assert_divides(_port_specs(rules.param_specs(params, ARCHS[arch],
                                                  tmesh)),
                    _shapes(params), tmesh)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_equal_the_reference(arch):
    for jmesh, tmesh in MESHES.values():
        for name, shape in INPUT_SHAPES.items():
            want = jrules.batch_spec(JARCHS[arch], JSHAPES[name], jmesh)
            got = rules.batch_spec(ARCHS[arch], shape, tmesh)
            assert got == {k: tuple(v) for k, v in want.items()}, name


@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference_and_divide(arch, shape):
    s = INPUT_SHAPES[shape]
    caches = tapi.init_cache(ARCHS[arch], s.global_batch, s.seq_len,
                             device="meta")
    jcaches = jax.eval_shape(lambda: japi.init_cache(
        JARCHS[arch], s.global_batch, s.seq_len))
    for jmesh, tmesh in MESHES.values():
        want = _jax_specs(jrules.cache_spec_tree(
            jcaches, JARCHS[arch], jmesh, s.global_batch, s.seq_len))
        got = _port_specs(rules.cache_spec_tree(
            caches, ARCHS[arch], tmesh, s.global_batch, s.seq_len))
        assert got == want
        _assert_divides(got, _shapes(caches), tmesh)


def test_tiny_models_skip_tp_and_the_production_shapes():
    assert not rules.use_tp(ARCHS["whisper-tiny"])
    assert not rules.use_tp(ARCHS["mamba2-130m"])
    assert rules.use_tp(ARCHS["gemma-7b"])
    assert production_mesh_shape(False).shape == {"data": 16, "model": 16}
    assert production_mesh_shape(True).shape == {"pod": 2, "data": 16,
                                                 "model": 16}
    assert rules.data_axes(production_mesh_shape(True)) == ("pod", "data")


def test_named_places_a_two_axis_dim_major_first():
    from torch.distributed.tensor import Replicate, Shard
    mesh = production_mesh_shape(True)
    got = rules.named(mesh, {"tokens": (("pod", "data"), None),
                             "bank": ("data", None, "model")})
    assert got == {"tokens": (Shard(0), Shard(0), Replicate()),
                   "bank": (Replicate(), Shard(0), Shard(2))}


def test_local_shards_put_back_together_give_the_full_arrays():
    """Every rank's shard of a (pod 2, data 2, model 2) mesh, placed at
    its offsets, covers each leaf exactly."""
    mesh = TAbstractMesh((2, 2, 2), ("pod", "data", "model"))
    rng = np.random.default_rng(0)
    full = {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 2, 10)).astype(np.float32)}}
    specs = {"a": (("pod", "data"), None), "b": {"c": ("data", None,
                                                       "model")}}
    for path, spec, size in (("a", specs["a"], (2, 6)),
                             ("c", specs["b"]["c"], (2, 2, 5))):
        seen = np.zeros((8, 6) if path == "a" else (4, 2, 10), int)
        for coord in (dict(zip(mesh.axis_names, c)) for c in
                      itertools.product(range(2), repeat=3)):
            mine = local_shards_from_numpy(full, specs, mesh, coord,
                                           device="cpu")
            leaf = mine["a"] if path == "a" else mine["b"]["c"]
            arr = full["a"] if path == "a" else full["b"]["c"]
            idx = rules.shard_index(mesh, spec, arr.shape, coord)
            assert tuple(leaf.shape) == size
            np.testing.assert_array_equal(leaf.numpy(), arr[idx])
            seen[idx] += 1
        # each spec leaves one axis of size 2 unnamed: every cell twice
        assert (seen == 2).all(), path
