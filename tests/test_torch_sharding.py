"""The port's sharding resolver (``distributed/sharding.py``) against the
reference's, spec for spec.

The reference's ``ShardingRules`` resolves against
``jax.sharding.AbstractMesh``es of the production shapes, which need no
devices; the port's against ``AbstractMesh``es of its own, which read only
the shape and the axis names, as a ``DeviceMesh`` has them.  No process
group is needed.  Every spec of every arch (the state, the params, the
caches and the inputs at each ``SHAPES`` entry) must resolve to the same
``PartitionSpec``, on ``single_pod``, ``multi_pod`` and ``host``, under
the cells' rule tables: training's, inference's (``embed`` replicated)
and the dry run's ``--override embed=none act_seq=model``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import list_archs
from repro.distributed.sharding import DEFAULT_RULES as J_DEFAULT_RULES
from repro.distributed.sharding import ShardingRules as JShardingRules
from repro.distributed.sharding import TensorSpec as JTensorSpec
from repro.models import api as japi
from repro_torch import tree as tu
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.distributed.sharding import (DEFAULT_RULES, AbstractMesh,
                                              ShardingRules, TensorSpec,
                                              constrain, current_rules,
                                              use_rules)
from repro_torch.launch import mesh
from repro_torch.models import api

MESHES = ["single_pod", "multi_pod", "host"]
RULE_SETS = {"train": {},
             "inference": {"embed": None},
             "override": {"embed": None, "act_seq": "model"}}


def _meshes(name: str):
    shape, axes = mesh.MESHES[name]
    return (JAbstractMesh(shape, axes), AbstractMesh(shape, axes))


def _norm(pspec) -> tuple:
    """A reference ``PartitionSpec`` as the port writes it: per dim a
    tuple of mesh-axis names."""
    return tuple(() if p is None else (p,) if isinstance(p, str)
                 else tuple(p) for p in pspec)


def _spec_trees(jcfg, cfg):
    """(reference tree, port tree) pairs of every spec tree a cell uses."""
    yield japi.state_specs(jcfg), api.state_specs(cfg)
    yield japi.param_specs(jcfg), api.param_specs(cfg)
    for name in SHAPES:
        jshape, shape = J_SHAPES[name], SHAPES[name]
        yield japi.input_specs(jcfg, jshape), api.input_specs(cfg, shape)
        yield (japi.cache_specs(jcfg, jshape.global_batch, jshape.seq_len),
               api.cache_specs(cfg, shape.global_batch, shape.seq_len))


def _j_leaves(tree) -> list:
    import jax
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x,
                                                              JTensorSpec))


def test_default_rules_are_the_references():
    assert DEFAULT_RULES == J_DEFAULT_RULES


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_every_spec_resolves_as_the_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    for overrides in RULE_SETS.values():
        jrules = JShardingRules(jmesh, log_replications=False)
        rules = ShardingRules(tmesh, log_replications=False)
        jrules.rules.update(overrides)
        rules.rules.update(overrides)
        n = 0
        for jtree, tree in _spec_trees(j_get_arch(arch), get_arch(arch)):
            jl, tl = _j_leaves(jtree), tu.leaves(tree)
            assert len(jl) == len(tl)
            for js, s in zip(jl, tl):
                assert (s.shape, s.axes) == (js.shape, js.axes)
                assert rules.spec_for(s) == _norm(jrules.spec_for(js)), \
                    (s.shape, s.axes)
                n += 1
        assert n > 30


# ------------------------------------------------ tests/test_sharding.py
def _rules(data: int = 2, model: int = 2) -> ShardingRules:
    return ShardingRules(AbstractMesh((data, model), ("data", "model")),
                         log_replications=False)


@pytest.mark.parametrize("shape,axes,want", [
    # divisible dims shard
    ((8, 6), ("embed", "ff"), (("data",), ("model",))),
    # 7 not divisible by 2 -> replicated; 6 divisible -> sharded
    ((7, 6), ("embed", "ff"), ((), ("model",))),
    ((1, 4), ("batch", "ff"), ((), ("model",))),
    # both dims map to "model": only the first gets it
    ((4, 4), ("cache_len", "cache_heads"), (("model",), ())),
    # no "pod" axis: ("pod", "data") falls back to data only
    ((4, 8, 16), ("batch", "seq", "embed"), (("data",), (), ())),
    ((4, 8), ("batch", None), (("data",), ())),
])
def test_resolver_cases(shape, axes, want):
    assert _rules().spec_for(TensorSpec(shape, axes)) == want


def test_resolver_property():
    """Over random dims, logical axes and mesh shapes: sharded extents
    divide their dims, a mesh axis is used at most once, and the spec is
    the reference's."""
    rng = np.random.default_rng(0)
    logical = list(DEFAULT_RULES) + [None]
    for _ in range(300):
        shape = (int(rng.integers(1, 3)), int(rng.integers(1, 5)),
                 int(rng.integers(1, 5)))
        names = ("pod", "data", "model")
        rules = ShardingRules(AbstractMesh(shape, names),
                              log_replications=False)
        jrules = JShardingRules(JAbstractMesh(shape, names),
                                log_replications=False)
        dims = tuple(int(d) for d in rng.integers(1, 65,
                                                  int(rng.integers(1, 5))))
        axes = tuple(logical[i] for i in rng.integers(0, len(logical),
                                                      len(dims)))
        spec = rules.spec_for(TensorSpec(dims, axes))
        assert spec == _norm(jrules.spec_for(JTensorSpec(dims, axes)))
        used = set()
        for dim, part in zip(dims, spec):
            extent = int(np.prod([shape[names.index(a)] for a in part]))
            assert dim % extent == 0
            assert not used & set(part)
            used |= set(part)


def test_placements_split_a_dim_over_its_axes_in_mesh_order():
    """A dim sharded over ("pod", "data") is ``Shard(d)`` on both those
    mesh dims; a mesh axis no dim uses replicates."""
    rules = ShardingRules(AbstractMesh((2, 16, 16),
                                       ("pod", "data", "model")))
    spec = rules.spec_for(TensorSpec((256, 4096, 2048),
                                     ("batch", None, "ff")))
    assert spec == (("pod", "data"), (), ("model",))
    assert rules.placements_for(spec) == (Shard(0), Shard(0), Shard(2))
    assert rules.placements_for(((), (), ())) == (Replicate(),) * 3
    assert rules.local_shape(TensorSpec((256, 4096, 2048),
                                        ("batch", None, "ff"))) \
        == (8, 4096, 128)


def test_constrain_is_the_identity_outside_use_rules():
    x = torch.arange(12.0).reshape(3, 4)
    assert current_rules() is None
    assert constrain(x, ("act_batch", None)) is x
    rules = _rules()
    with use_rules(rules):
        assert current_rules() is rules
        # a plain tensor passes through a mesh's rules untouched too
        assert constrain(x, ("act_batch", None)) is x
    assert current_rules() is None
