"""Port parity for the spec-tree builders (``repro_torch.models.specs``)
against ``repro/models/specs.py``.

``param_specs`` is held leaf for leaf through the bridge's mapping: JAX's
param tree (``jax.eval_shape`` of ``model.init``, or of
``quantize_for_serving`` of it) is filled with integer codes, leaf id x
1000 + the index along its leading axis, and bridged
(``repro_torch.bridge.params_from_numpy``), so each port leaf says which
JAX leaf it came from and, for a stacked JAX leaf, which layer. The port's
spec of a leaf must be JAX's, with JAX's leading stack dim dropped where
the bridge unstacked it; ``embed/table_f32`` (the port's fp32 copy of a
tied table) takes the table's spec. ``cache_specs`` is held by leaf name
against ``jax.eval_shape`` of ``model.init_cache`` (JAX nests the MoE and
hybrid caches by block kind where the port's are flat stacks: a JAX leaf
of the port leaf's rank compares whole, a hybrid tail leaf, one rank
less, against the port spec without its layer dim). Every registry arch's
smoke config, under five policies: model 4; data 2 x model 4 with fsdp;
expert_2d; replicate_batch; int8 serving weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.models import specs as jspecs  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.quant.int8 import quantize_for_serving  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import specs  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

POLICIES = {
    "model4": dict(data="data", model="model", mesh_axis_sizes={"model": 4}),
    "data2_model4_fsdp": dict(data="data", model="model", fsdp=True,
                              mesh_axis_sizes={"data": 2, "model": 4}),
    "expert_2d": dict(data="data", model="model", expert_2d=True,
                      mesh_axis_sizes={"data": 2, "model": 4}),
    "replicate_batch": dict(data="data", model="model", replicate_batch=True,
                            mesh_axis_sizes={"data": 2, "model": 4}),
    "int8_serving": dict(data="data", model="model",
                         mesh_axis_sizes={"data": 2, "model": 4}),
}
BATCH, MAX_LEN, SLACK = 4, 64, 16


def _policies(name):
    kw = POLICIES[name]
    return specs.ShardingPolicy(**kw), jspecs.ShardingPolicy(**kw)


def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):       # a spec (a tuple) is a leaf
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}/{i}")
    else:
        yield path, tree


def _coded(jshape):
    """JAX's shape tree as int64 numpy leaves holding id * 1000 + the index
    along axis 0."""
    leaves, treedef = jax.tree_util.tree_flatten(jshape)
    out = []
    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        if not shape:
            out.append(np.asarray(i * 1000, np.int64))
            continue
        col = np.arange(shape[0], dtype=np.int64).reshape((-1,) + (1,) * (len(shape) - 1))
        out.append(np.ascontiguousarray(np.broadcast_to(i * 1000 + col, shape)))
    return jax.tree_util.tree_unflatten(treedef, out), leaves


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_param_specs_are_jaxs_leaf_for_leaf(arch, policy):
    pol, jpol = _policies(policy)
    jcfg = jax_registry.smoke_config(arch)
    cfg = registry.smoke_config(arch)
    jm = jax_build(jcfg)
    if policy == "int8_serving":
        jshape = jax.eval_shape(lambda: quantize_for_serving(
            jm.init(jax.random.PRNGKey(0))))
    else:
        jshape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jspec_leaves = jax.tree_util.tree_leaves(
        jspecs.param_specs(jcfg, jshape, jpol),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    coded, jleaves = _coded(jshape)
    port = params_from_numpy(cfg, coded, "cpu")
    if policy != "int8_serving":          # the bridge gives the port's tree
        def shapes(tree):        # an int64 table gets an fp32 copy
            return sorted((p, tuple(t.shape)) for p, t in _leaves_with_path(tree)
                          if not p.endswith("table_f32"))
        assert shapes(build_model(cfg).init(0, "meta")) == shapes(port)
    got = dict(_leaves_with_path(specs.param_specs(cfg, port, pol)))
    seen = set()
    for path, leaf in _leaves_with_path(port):
        if path.endswith("embed/table_f32"):
            assert got[path] == got[path[:-len("_f32")]]
            continue
        code = int(leaf.reshape(-1)[0])
        j = code // 1000
        jshape_j, jspec = tuple(jleaves[j].shape), tuple(jspec_leaves[j])
        if tuple(leaf.shape) == jshape_j:
            assert got[path] == jspec, (path, got[path], jspec)
        else:                              # unstacked by the bridge
            assert tuple(leaf.shape) == jshape_j[1:], path
            assert got[path] == jspec[1:], (path, got[path], jspec)
        seen.add(j)
    assert seen == set(range(len(jleaves)))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_cache_specs_are_jaxs_by_leaf_name(arch, policy):
    pol, jpol = _policies(policy)
    jcfg = jax_registry.smoke_config(arch)
    cfg = registry.smoke_config(arch)
    jm, m = jax_build(jcfg), build_model(cfg)
    jcache = jax.eval_shape(lambda: jm.init_cache(BATCH, m.cache_len(MAX_LEN),
                                                  spec_slack=SLACK))
    cache = m.cache_spec(BATCH, m.cache_len(MAX_LEN), spec_slack=SLACK)
    jflat = [(str(getattr(p[-1], "key", getattr(p[-1], "idx", ""))), leaf, s)
             for (p, leaf), s in zip(
                 jax.tree_util.tree_flatten_with_path(jcache)[0],
                 jax.tree_util.tree_leaves(
                     jspecs.cache_specs(jcfg, jcache, jpol, BATCH),
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))]
    got = specs.cache_specs(cfg, cache, pol, BATCH)
    names = set()
    for name, leaf in cache.items():
        if not isinstance(leaf, torch.Tensor):
            continue                       # a windowed ring's ``positions``
        mine = [(jleaf, tuple(s)) for key, jleaf, s in jflat if key == name]
        assert mine, name
        for jleaf, jspec in mine:
            if len(jleaf.shape) == leaf.dim():
                # the port's ring rounds W up to 16 slots (72 -> 80 for
                # the VLM's 64 + 8 positions): both divide by every axis
                assert got[name] == jspec, (name, got[name], jspec)
            else:                           # a hybrid tail unit: [B, ...]
                assert len(jleaf.shape) == leaf.dim() - 1, name
                assert got[name][1:] == jspec, (name, got[name], jspec)
        names.add(name)
    assert names == {key for key, _, _ in jflat}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_io_specs_are_jaxs(policy):
    pol, jpol = _policies(policy)
    for batch in (1, 2, 3, 8):
        tok, logits = specs.io_specs(pol, batch)
        jtok, jlogits = jspecs.io_specs(jpol, batch)
        assert (tok, logits) == (tuple(jtok), tuple(jlogits))


def test_shard_plan_and_local_shapes_follow_the_spec():
    """``shard_plan`` gives each device of a data 2 x model 4 submesh the
    slice NamedSharding would: a dim on ("data", "model") split data-major
    into 8, a dim on "model" into 4 by the device's model coordinate, a
    replicated dim whole; ``local_shapes`` agrees with every slice."""
    pol = specs.ShardingPolicy(data="data", model="model",
                               mesh_axis_sizes={"data": 2, "model": 4})
    tree = {"a": torch.empty((16, 8), device="meta"),
            "b": {"c": torch.empty((3, 12), device="meta")}}
    spec_tree = {"a": (("data", "model"), None), "b": {"c": (None, "model")}}
    plan = specs.shard_plan(spec_tree, tree, ("data", "model"), (2, 4))
    local = specs.local_shapes(spec_tree, tree, pol)
    assert local == {"a": (2, 8), "b": {"c": (3, 3)}}
    for j, coords in enumerate(specs.mesh_coords(("data", "model"), (2, 4))):
        a, c = plan["a"].slices[j], plan["b"]["c"].slices[j]
        k = coords["data"] * 4 + coords["model"]
        assert a == (slice(2 * k, 2 * k + 2), slice(0, 8))
        assert c == (slice(0, 3), slice(3 * coords["model"], 3 * coords["model"] + 3))
        assert plan["a"].local == local["a"]
    with pytest.raises(ValueError, match="does not split"):
        specs.leaf_plan((None, "model"), (3, 10), ("model",), (4,))
