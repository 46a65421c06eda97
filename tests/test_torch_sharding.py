"""The port's sharding layer (`repro_torch.sharding`, `launch/mesh.py`,
`launch/shapes.py`, the logical-axes and abstract trees of
`models/params.py` and `models/model.py`) against the reference's, in
one process (no ranks: the rule tables read only a mesh's names and
shape, so both sides take a fake mesh, as tests/test_sharding.py does).

- `make_rules`, `moe_mode_for`, and `tree_specs` of the parameter and
  cache trees, entry by entry, on every arch x {train, serve} x meshes
  {data 16 x model 16, pod 2 x data 16 x model 16, 2 x 2, 2 x 4};
- `param_logical_axes` and `cache_logical_axes` equal the reference's
  trees; `abstract_params`, `abstract_cache` and `input_specs` its
  shapes and dtypes;
- `gather_leaf(shard_leaf(x))` is x on every rank layout, each shard
  contiguous and of `local_shape`; `shard_params` of a full tree (fp32
  and int8) gathers back to it.
"""


import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro.models import params as jax_params
from repro.models.model import abstract_cache as jax_abstract_cache
from repro.models.model import cache_logical_axes as jax_cache_axes
from repro.sharding import make_parallel as jax_make_parallel
from repro.sharding import make_rules as jax_make_rules
from repro.sharding import moe_mode_for as jax_moe_mode_for
from repro.sharding import tree_specs as jax_tree_specs
from repro_torch import sharding as S
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import shapes
from repro_torch.models.model import (abstract_cache, cache_logical_axes,
                                      init_params)
from repro_torch.models.params import (abstract_params, param_logical_axes,
                                       shard_params)
from repro_torch.quant.int8 import quantize_exec_tree

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
    "2x4": {"data": 2, "model": 4},
}


class JaxFakeMesh:
    """What the reference's rule tables read of a jax Mesh."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    @property
    def devices(self):
        return np.empty(tuple(self.shape.values()))


class FakeMesh:
    """What the port reads of a DeviceMesh: names, shape and (for
    shard_params) this rank's coordinates."""

    def __init__(self, shape, coords=None):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())
        self._coords = coords or {a: 0 for a in shape}

    def get_local_rank(self, axis):
        return self._coords[axis]


def _pair(mesh, profile, **kw):
    return (jax_make_parallel(JaxFakeMesh(MESHES[mesh]), profile, **kw),
            S.make_parallel(FakeMesh(MESHES[mesh]), profile, **kw))


def _jax_flat(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _flat(tree, leaf):
    """Leaves in jax.tree's order (dict keys sorted); `leaf` says what
    counts as one."""
    if leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flat(t, leaf)]
    return [tree]


def _specs_equal(port_tree, jax_tree):
    """Leaf by leaf, each port Spec as a PartitionSpec equals the
    reference's: jax 0.9 stores a one-axis tuple entry as the axis name
    (P(("data",)) == P("data")), so the entries are compared through
    P; the port keeps the tuple (test_spec_entries_keep_...)."""
    got = _flat(port_tree, lambda x: isinstance(x, S.Spec))
    want = _jax_flat(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, S.Spec) and isinstance(w, P)
        assert len(g) == len(w) and P(*g) == w, (g, w)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("profile", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_match_reference(arch, profile, mesh):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jpar, tpar = _pair(mesh, profile)
    assert tpar.data_axes == jpar.data_axes
    assert (tpar.seq_shard, tpar.profile) == (jpar.seq_shard, jpar.profile)
    for cfg_pair in ((None, None), (jcfg, tcfg)):
        assert S.make_rules(tpar, cfg_pair[1]) == \
            jax_make_rules(jpar, cfg_pair[0])
    for mode in ("auto", "auto2d", "ep", "tp"):
        jp, tp = _pair(mesh, profile, moe_mode=mode)
        assert S.moe_mode_for(tcfg, tp) == jax_moe_mode_for(jcfg, jp)
    _specs_equal(S.tree_specs(param_logical_axes(tcfg), tpar, tcfg),
                 jax_tree_specs(jax_params.param_logical_axes(jcfg), jpar,
                                jcfg))
    _specs_equal(S.tree_specs(cache_logical_axes(tcfg, 4, 64), tpar, tcfg),
                 jax_tree_specs(jax_cache_axes(jcfg, 4, 64), jpar, jcfg))
    assert P(*S.batch_spec(tpar, 3)) == P(jpar.data_axes, None, None)


def test_spec_entries_keep_the_reference_distinctions():
    """Tuple rules stay tuples after dedup, a str rule used twice gives
    None, the scalar sentinel gives an empty spec (tests/test_sharding.py
    pins the same on the reference)."""
    rules = {"a": ("data", "model"), "b": "model", "c": ("data",)}
    assert S.spec_for(("a", "b"), rules) == S.Spec(("data", "model"), None)
    assert S.spec_for(("c",), rules) == S.Spec(("data",))
    assert S.spec_for(("c",), rules) != S.Spec("data")
    assert S.spec_for(S.SCALAR_AXES, rules) == S.Spec() == ()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_and_abstract_trees_match_reference(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert param_logical_axes(tcfg) == jax_params.param_logical_axes(jcfg)
    assert cache_logical_axes(tcfg, 2, 16) == jax_cache_axes(jcfg, 2, 16)
    for got, want in ((abstract_params(tcfg),
                       jax_params.abstract_params(jcfg)),
                      (abstract_cache(tcfg, 8, 4096),
                       jax_abstract_cache(jcfg, 8, 4096))):
        g = _flat(got, lambda x: isinstance(x, torch.Tensor))
        w = jax.tree.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name


@pytest.mark.parametrize("shape_name", jax_shapes.SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape_name):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert shapes.SHAPE_NAMES == jax_shapes.SHAPE_NAMES
    assert shapes.SHAPE_DEFS == jax_shapes.SHAPE_DEFS
    assert shapes.cell_runnable(tcfg, shape_name) == \
        jax_shapes.cell_runnable(jcfg, shape_name)
    assert shapes.skip_reason(tcfg, shape_name) == \
        jax_shapes.skip_reason(jcfg, shape_name)
    got = shapes.input_specs(tcfg, shape_name)
    want = jax_shapes.input_specs(jcfg, shape_name)
    g = _flat(got, lambda x: isinstance(x, (torch.Tensor, int, str)))
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(a, torch.Tensor):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name
        else:
            assert a == b


ROUND_TRIPS = [
    ({"data": 2, "model": 2}, (None, ("data",), "model", None)),
    ({"data": 2, "model": 4}, (("data",), "model", None, None)),
    ({"data": 2, "model": 4}, (None, None, ("data", "model"), None)),
    ({"pod": 2, "data": 2, "model": 2}, (("pod", "data"), None, "model",
                                         None)),
    ({"pod": 2, "data": 2, "model": 2}, (None, ("data", "model"), None,
                                         ("pod",))),
    ({"data": 2, "model": 4}, ()),
]


def _all_coords(sizes):
    return [dict(zip(sizes, c)) for c in np.ndindex(*sizes.values())]


@pytest.mark.parametrize("sizes, entries", ROUND_TRIPS)
def test_gather_leaf_inverts_shard_leaf(sizes, entries):
    spec = S.Spec(*entries)
    x = torch.arange(8 * 8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 8, 4)
    shards = {}
    for c in _all_coords(sizes):
        sh = S.shard_leaf(x, spec, sizes, c)
        assert sh.is_contiguous()
        assert tuple(sh.shape) == S.local_shape(x.shape, spec, sizes)
        if sh.numel() < x.numel():
            assert sh.untyped_storage().data_ptr() != \
                x.untyped_storage().data_ptr()
        shards[tuple(c.values())] = sh
    assert torch.equal(S.gather_leaf(shards, spec, sizes), x)


def test_shard_leaf_refuses_an_indivisible_dim():
    with pytest.raises(ValueError, match="does not split"):
        S.shard_leaf(torch.zeros(6, 3), S.Spec(None, "model"),
                     {"data": 2, "model": 2}, {"data": 0, "model": 1})


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("arch, mesh", [("stablelm_1_6b", "2x2"),
                                        ("yi_9b", "2x4"),
                                        ("gemma2_9b", "2x4")])
def test_shard_params_gathers_back(arch, mesh, quant):
    """Every rank's `shard_params` of a full tree, gathered by the specs
    of `param_logical_axes`, is the tree; int8 scales follow the output
    axes of their weight (size 1 on the contracted ones)."""
    cfg = reduced_config(arch)
    full = init_params(cfg, 0, device="cpu")
    if quant:
        full = quantize_exec_tree(full)
    sizes = MESHES[mesh]
    per_rank = {}
    for c in _all_coords(sizes):
        par = S.make_parallel(FakeMesh(sizes, c), "serve")
        per_rank[tuple(c.values())] = shard_params(full, cfg, par)
    par = S.make_parallel(FakeMesh(sizes), "serve")
    specs = _flat(S.tree_specs(param_logical_axes(cfg), par, cfg),
                  lambda x: isinstance(x, S.Spec))
    leaf = lambda x: isinstance(x, torch.Tensor) or (
        isinstance(x, dict) and set(x) == {"q", "scale"})
    want = _flat(full, leaf)
    ranks = {k: _flat(v, leaf) for k, v in per_rank.items()}
    assert len(specs) == len(want)
    for i, (spec, w) in enumerate(zip(specs, want)):
        if isinstance(w, dict):
            q = S.gather_leaf({k: r[i]["q"] for k, r in ranks.items()},
                              spec, sizes)
            sspec = S.Spec(*(e if w["scale"].shape[d] == w["q"].shape[d]
                             else None for d, e in enumerate(spec)))
            s = S.gather_leaf({k: r[i]["scale"] for k, r in ranks.items()},
                              sspec, sizes)
            assert torch.equal(q, w["q"]) and torch.equal(s, w["scale"])
        else:
            assert torch.equal(S.gather_leaf(
                {k: r[i] for k, r in ranks.items()}, spec, sizes), w)
        for r in ranks.values():
            for t in (r[i].values() if isinstance(r[i], dict) else [r[i]]):
                assert t.is_contiguous()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        port_mesh.make_production_mesh()
    assert port_mesh.PRODUCTION_SHAPE == (16, 16)
    assert port_mesh.MULTI_POD_AXES == ("pod", "data", "model")
