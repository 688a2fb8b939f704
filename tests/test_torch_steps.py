"""The port's step builders (``launch.steps``), ``Model.cache_spec``, the
meta-device init and the microbatch check of the train step, against
``repro``'s on the CPU.

Shapes: each builder's ``inputs`` (meta tensors) against JAX's builder's
(ShapeDtypeStructs, built on a 1 x 1 mesh) leaf for leaf in shape and
dtype, for one smoke config of each family. JAX stacks layers on axis 0
and the port keeps per-layer tensors, so the port's params are compared
as ``optimizer.layout``'s groups (JAX's stacked leaves, by JAX's path) and
its caches as JAX's unit stacks joined along the layer axis (the port's
flat moe and hybrid caches), rings rounded up to ``dense.RING_PAGE``
slots (the port's layout).

Runs: the steps on bridged smoke weights against JAX's jitted steps on the
same seeded inputs: prefill and decode logits at fp32 rtol 1e-4, atol
1e-5; the spec round's tokens, n_commit and cache indices exactly; the
train step's loss at rtol 1e-5 and each param after one AdamW step at
|d| <= 1e-5 max|p| + 1e-6 (eps 1e-4, as in test_torch_train_loop.py,
which says why)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.specs import ShardingPolicy as JaxPolicy  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train_loop as jax_tl  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import dense  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

FAMILIES = {"dense": "llama3.2-1b", "moe": "mixtral-8x7b", "ssm": "mamba2-780m",
            "hybrid": "recurrentgemma-2b", "vlm": "internvl2-26b",
            "encdec": "whisper-large-v3"}
B, S = 2, 16
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def mesh():
    m = jax.make_mesh((1, 1), ("data", "model"))
    return m, JaxPolicy(data="data", model="model",
                        mesh_axis_sizes={"data": 1, "model": 1})


# ------------------------------------------------------------------ shapes
def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _keys(path):
    return [str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
            for p in path]


def _jax_leaves(tree) -> dict:
    """{"a/b/c": (shape, dtype)} of a JAX tree."""
    return {"/".join(_keys(path)): (tuple(leaf.shape), _dt(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_params(cfg, params) -> dict:
    """The port's per-layer tensors as JAX's stacked leaves (the groups of
    ``optimizer.layout``, named by JAX's paths)."""
    out = {}
    for g in opt.layout(cfg, params):
        ts = [opt.get(params, p) for p in g.paths]
        assert len({(t.shape, t.dtype) for t in ts}) == 1, g.name
        out[g.name] = (((len(ts),) if g.stacked else ()) + tuple(ts[0].shape),
                       _dt(ts[0]))
    return out


def _port_opt(cfg, state) -> dict:
    """An optimizer state's leaves by JAX's paths. The step count is a host
    int in the port (JAX: an int32 scalar), 0 at init."""
    assert state.step == 0
    out = {"step": ((), "int32")}
    if isinstance(state, opt.OptState):
        for f in ("mu", "nu"):
            out.update({f"{f}/{k}": v
                        for k, v in _port_params(cfg, getattr(state, f)).items()})
    else:
        for f in ("vr", "vc", "v"):
            out.update({f"{f}/{k}": (tuple(t.shape), _dt(t))
                        for k, t in getattr(state, f).items()})
    return out


def _ring(n) -> int:
    return -(-n // dense.RING_PAGE) * dense.RING_PAGE


def _jax_cache_as_port(jcache) -> dict:
    """JAX's cache as the port's flat leaves: each stack of units (the
    layers, a MoE block kind, a hybrid pattern slot) joined along the layer
    axis, ``tail`` units one layer each; rings rounded up to RING_PAGE."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        keys, shape = _keys(path), tuple(leaf.shape)
        name = keys[-1]
        if name == "index":
            out[name] = (shape, _dt(leaf))
            continue
        n, rest = (1, shape) if keys[0] == "tail" else (shape[0], shape[1:])
        if name in ("k", "v"):
            rest = (rest[0], _ring(rest[1])) + rest[2:]
        if name in out:
            assert out[name][0][1:] == rest and out[name][1] == _dt(leaf), keys
            n += out[name][0][0]
        out[name] = ((n,) + rest, _dt(leaf))
    return out


def _port_cache(cache) -> dict:
    return {k: (tuple(t.shape), _dt(t)) for k, t in cache.items()
            if isinstance(t, torch.Tensor)}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _pair(arch, **kw):
    jcfg = jax_registry.smoke_config(arch).replace(**kw)
    cfg = registry.smoke_config(arch).replace(**kw)
    assert cfg.name == jcfg.name
    return jcfg, cfg, jax_build(jcfg), build_model(cfg)


@pytest.mark.parametrize("dtype", [None, torch.int8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cache_spec_is_init_cache_on_meta_and_jaxs(family, dtype):
    """``cache_spec`` gives ``init_cache``'s tree on the meta device, and
    JAX's ``cache_spec`` through the mapping (windowed and local rings at
    a max_len past the window: the port's ring keeps ``positions``)."""
    _, cfg, jm, m = _pair(FAMILIES[family])
    spec = m.cache_spec(B, 40, spec_slack=8, dtype=dtype)
    real = m.init_cache(B, 40, spec_slack=8, dtype=dtype, device="cpu")
    assert spec.keys() == real.keys()
    assert all(t.is_meta for t in _tensors(spec))
    assert _port_cache(spec) == _port_cache(real)
    assert {k: v for k, v in spec.items() if not isinstance(v, torch.Tensor)} \
        == {k: v for k, v in real.items() if not isinstance(v, torch.Tensor)}
    jspec = jm.cache_spec(B, 40, spec_slack=8,
                          dtype=None if dtype is None else jnp.int8)
    assert _port_cache(spec) == _jax_cache_as_port(jspec)
    if "k" in spec:
        W = spec["k"].shape[2]
        assert spec.get("positions", W) == max(W, _ring(40))


@pytest.mark.parametrize("dtype", [None, torch.int8])
def test_mixtral_ring_is_window_bounded(dtype):
    """The port's counterpart of tests/test_models.py's window test: the
    full Mixtral 8x7B's cache over 32768 positions holds 4096 slots (its
    window) and reads through a table over the 32768 positions."""
    cfg = registry.config("mixtral-8x7b")
    spec = build_model(cfg).cache_spec(4, 32768, spec_slack=0, dtype=dtype)
    assert spec["k"].shape[2] == cfg.sliding_window == 4096
    assert spec["positions"] == 32768
    assert spec["k"].dtype == (dtype or cfg.act_dtype) and spec["k"].is_meta
    jm = jax_build(jax_registry.config("mixtral-8x7b"))
    jspec = jm.cache_spec(4, 32768, spec_slack=0,
                          dtype=None if dtype is None else jnp.int8)
    assert _port_cache(spec) == _jax_cache_as_port(jspec)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_init_is_the_real_init_without_draws(family):
    """``init`` on meta: the real init's tree, shapes and dtypes (bf16
    params too), every leaf meta, and no generator draws (the default
    one's state is untouched; a seed is not even read)."""
    _, cfg, _, _ = _pair(FAMILIES[family], dtype="bfloat16", param_dtype="bfloat16")
    m = build_model(cfg)
    state = torch.random.get_rng_state()
    meta = m.init(None, "meta")
    assert torch.equal(torch.random.get_rng_state(), state)
    real = m.init(0, "cpu")
    assert all(t.is_meta for t in _tensors(meta))
    flat = lambda tree: [(tuple(t.shape), t.dtype) for t in _tensors(tree)]  # noqa: E731
    assert flat(meta) == flat(real)


# ------------------------------------------------------------ builder inputs
def _compare_inputs(cfg, got, want, dcfg=None):
    assert got.keys() == want.keys()
    assert all(t.is_meta for t in _tensors(got))
    for key, jtree in want.items():
        port = got[key]
        if key in ("params", "params_t", "params_d"):
            c = dcfg if key == "params_d" else cfg
            assert _port_params(c, port) == _jax_leaves(jtree), key
        elif key == "opt_state":
            assert _port_opt(cfg, port) == _jax_leaves(jtree)
        elif key in ("cache", "tcache", "dcache"):
            assert _port_cache(port) == _jax_cache_as_port(jtree), key
        else:
            assert {"/".join(map(str, p)): (tuple(t.shape), _dt(t))
                    for p, t in opt.leaves(port)} == _jax_leaves(jtree), key


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_builder_inputs_match_jax(family, mesh):
    """Every builder's inputs, leaf for leaf: train (AdamW; Adafactor for
    the dense family; two microbatches), prefill and decode with and
    without int8 weights and an int8 cache (the encoder-decoder's decode
    with its cross K/V), each against JAX's on a 1 x 1 mesh."""
    jmesh, pol = mesh
    _, cfg, jm, m = _pair(FAMILIES[family])
    ocfgs = [(opt.AdamWConfig(), jax_opt.AdamWConfig())]
    if family == "dense":
        ocfgs.append((opt.AdafactorConfig(), jax_opt.AdafactorConfig()))
    with jmesh:
        for ocfg, jocfg in ocfgs:
            _, got = steps.build_train_step(m, ShapeConfig("t", S, 4, "train"), 2, ocfg)
            _, want = jax_steps.build_train_step(
                jm, jmesh, pol, JaxShape("t", S, 4, "train"), 2, jocfg)
            _compare_inputs(cfg, got, want)
        for kind, build, jbuild in (
                ("prefill", steps.build_prefill_step, jax_steps.build_prefill_step),
                ("decode", steps.build_decode_step, jax_steps.build_decode_step)):
            for q in (False, True):
                for kv in (False, True):
                    _, got = build(m, ShapeConfig("s", 32, B, kind), q, kv)
                    _, want = jbuild(jm, jmesh, pol, JaxShape("s", 32, B, kind), q, kv)
                    _compare_inputs(cfg, got, want)
    if family == "encdec":
        assert set(got["extras"]) == {"cross"}


# ------------------------------------------------------------------- runs
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, seed=0, **kw):
    jcfg, cfg, jm, m = _pair(arch, **kw)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    return jcfg, cfg, jm, m, jp, params_from_numpy(cfg, _np(jp), "cpu")


def _zeros(jtree):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jtree)


def _port_zeros(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _port_zeros(v) for k, v in tree.items()}
    return tree


def _normal(rng, jtree):
    """Seeded normal stand-ins for the modality inputs (numpy, fp32)."""
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), jtree)


def _to_port(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("family", ["dense", "moe", "encdec"])
def test_prefill_and_decode_steps_match_jax(family, mesh):
    """The prefill step over S - 1 tokens on a fresh cache of S (the
    decode step's), then the decode step on the next token (the
    encoder-decoder's with seeded cross K/V), against JAX's jitted steps
    on the same inputs: logits and cache indices."""
    jmesh, pol = mesh
    _, cfg, jm, m, jp, tp = _setup(FAMILIES[family])
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fn, _ = steps.build_prefill_step(m, ShapeConfig("p", S, B, "prefill"))
    dfn, dinp = steps.build_decode_step(m, ShapeConfig("d", S, B, "decode"))
    with jmesh:
        jfn, jinp = jax_steps.build_prefill_step(
            jm, jmesh, pol, JaxShape("p", S, B, "prefill"))
        jdfn, jdinp = jax_steps.build_decode_step(
            jm, jmesh, pol, JaxShape("d", S, B, "decode"))
        ex, dex = _normal(rng, jinp["extras"]), _normal(rng, jdinp["extras"])
        jl, jcache = jfn(jp, jnp.asarray(toks[:, :-1]), _zeros(jdinp["cache"]),
                         _to_jax(ex))
        tl, tcache = fn(tp, torch.as_tensor(toks[:, :-1]),
                        _port_zeros(dinp["cache"]), _to_port(ex))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tl.shape == (B, 1, cfg.vocab_size)
        assert int(tcache["index"]) == int(jcache["index"]) == S - 1
        jl, jcache = jdfn(jp, jnp.asarray(toks[:, -1:]), jcache, _to_jax(dex))
        tl, tcache = dfn(tp, torch.as_tensor(toks[:, -1:]), tcache, _to_port(dex))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tcache["index"]) == int(jcache["index"]) == S


def _spec_pair(family):
    """A pair that disagrees in some rounds, from one jitted JAX init: the
    drafter is the target's first L - 1 layers (dense: ``llama3.2-1b``
    smoke, embedding std d**-0.5) or its first block (moe: ``mixtral-8x7b``
    smoke, std-1 embedding), as ``_serving_parity``'s pairs."""
    d = jax_registry.smoke_config(FAMILIES[family]).d_model
    kw = {"embed_init_scale": d ** -0.5} if family == "dense" else {}
    jcfg, cfg, jt, mt = _pair(FAMILIES[family], **kw)
    n_d = jcfg.num_layers - 1 if family == "dense" else max(jcfg.moe_every, 1)
    jd = jax_build(jcfg.replace(num_layers=n_d, name="draft"))
    md = build_model(cfg.replace(num_layers=n_d, name="draft"))
    jpt = jax.jit(jt.init)(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:n_d], jpt["layers"])}
    return (jt, jd, jpt, jpd, mt, md, params_from_numpy(cfg, _np(jpt), "cpu"),
            params_from_numpy(md.cfg, _np(jpd), "cpu"))


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_spec_round_step_matches_jax(family, mesh):
    """The spec-round builder's inputs against JAX's, leaf for leaf; then
    one round from caches prefilled with P - 1 prompt tokens (the last one
    is ``t_last``), for three seeded prompt batches: JAX's jitted round and
    the port's give the same tokens, n_commit and cache indices; some
    round commits fewer than gamma + 1 tokens."""
    jmesh, pol = mesh
    jt, jd, jpt, jpd, mt, md, pt, pd = _spec_pair(family)
    gamma, P = 4, 12
    shape = ShapeConfig("s", 32, B, "decode")
    fn, inp = steps.build_spec_round_step(mt, md, shape, gamma)
    japply_t, japply_d = jax.jit(jt.apply), jax.jit(jd.apply)
    commits = []
    with jmesh:
        jfn, jinp = jax_steps.build_spec_round_step(
            jt, jd, jmesh, pol, pol, JaxShape("s", 32, B, "decode"), gamma)
        _compare_inputs(mt.cfg, inp, jinp, dcfg=md.cfg)
        for seed in range(3):
            prompt = np.random.default_rng(seed).integers(
                0, mt.cfg.vocab_size, (B, P)).astype(np.int32)
            _, jtc, _ = japply_t(jpt, jnp.asarray(prompt[:, :-1]), _zeros(jinp["tcache"]))
            _, jdc, _ = japply_d(jpd, jnp.asarray(prompt[:, :-1]), _zeros(jinp["dcache"]))
            _, ttc, _ = mt.apply(pt, torch.as_tensor(prompt[:, :-1]),
                                 _port_zeros(inp["tcache"]))
            _, tdc, _ = md.apply(pd, torch.as_tensor(prompt[:, :-1]),
                                 _port_zeros(inp["dcache"]))
            jout, jn, jtc, jdc = jfn(jpt, jpd, jnp.asarray(prompt[:, -1]), jtc, jdc)
            out, n, ttc, tdc = fn(pt, pd, torch.as_tensor(prompt[:, -1]), ttc, tdc)
            np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
            assert int(n) == int(jn) >= 1
            assert int(ttc["index"]) == int(jtc["index"]) == P - 1 + int(n)
            assert int(tdc["index"]) == int(jdc["index"]) == P - 1 + int(n)
            commits.append(int(n))
    assert min(commits) < gamma + 1


def _assert_params_close(cfg, port, jtree):
    want = params_from_numpy(cfg, _np(jtree), "cpu")
    assert sorted(str(p) for p, _ in opt.leaves(want)) == \
        sorted(str(p) for p, _ in opt.leaves(port))
    for path, y in opt.leaves(want):
        x = opt.get(port, path).float()
        err = float((x - y.float()).abs().max())
        tol = 1e-5 * float(y.float().abs().max()) + 1e-6
        assert err <= tol, (path, err, tol)


@pytest.mark.parametrize("arch,nmb", [("llama3.2-1b", 2), ("mixtral-8x7b", 1)])
def test_train_step_matches_jax(arch, nmb, mesh):
    """One AdamW step of the built train step against JAX's jitted one on
    the same batch of 4: the loss and every param after the step."""
    jmesh, pol = mesh
    _, cfg, jm, m, jp, tp = _setup(arch, embed_init_scale=0.1)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=3, eps=1e-4)
    fn, inp = steps.build_train_step(m, ShapeConfig("t", S, 4, "train"), nmb,
                                     opt.AdamWConfig(**kw))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (4, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with jmesh:
        jfn, _ = jax_steps.build_train_step(
            jm, jmesh, pol, JaxShape("t", S, 4, "train"), nmb, jax_opt.AdamWConfig(**kw))
        jp2, _, jmet = jfn(jp, jax_opt.init(jp), _to_jax(batch))
    state = train_loop.init_opt_state(m, opt.AdamWConfig(**kw), tp)
    tp2, state, met = fn(tp, state, _to_port(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    assert state.step == 1
    _assert_params_close(cfg, tp2, jp2)


def test_uneven_microbatches_raise_before_any_forward():
    """B 3 over 2 microbatches: JAX's reshape raises TypeError; the port
    raises ValueError naming both numbers before any forward (it once
    dropped the third row)."""
    _, cfg, jm, m, jp, tp = _setup("llama3.2-1b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.raises(TypeError):
        jax_tl.make_train_step(jm, jax_opt.AdamWConfig(), 2)(
            jp, jax_opt.init(jp), _to_jax(batch))
    calls = []
    apply = m.apply
    m.apply = lambda *a, **k: calls.append(1) or apply(*a, **k)
    ocfg = opt.AdamWConfig()
    fn, _ = steps.build_train_step(m, ShapeConfig("t", S, 3, "train"), 2, ocfg)
    with pytest.raises(ValueError, match=r"3 rows.*num_microbatches=2"):
        fn(tp, train_loop.init_opt_state(m, ocfg, tp), _to_port(batch))
    assert not calls
