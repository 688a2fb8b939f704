"""Port parity: the weight bridge, the paged KV write and the dense model's
paged forward, against the JAX package on the ``llama3.2-1b`` smoke pair
(target from PRNGKey(0), drafter from PRNGKey(7) with one layer fewer, as
tests/goldens/gen_goldens.py builds it).

Tolerances: the bridge and a KV write of identical inputs are exact; the
model's logits are held to fp32 atol=1e-4, rtol=1e-5 (XLA and PyTorch sum
the matmuls in different orders), and the pools it writes to 1e-5. Every
pool slot the JAX model leaves untouched must be untouched (exactly zero)
in the port too, and the cache index must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jax_paged_kv  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg_t = jax_registry.smoke_config("llama3.2-1b")
    jcfg_d = jcfg_t.replace(num_layers=jcfg_t.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg_t), jax_build(jcfg_d)
    jpt, jpd = jt.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(7))
    cfg_t = registry.smoke_config("llama3.2-1b")
    cfg_d = cfg_t.replace(num_layers=cfg_t.num_layers - 1, name="draft")
    tree_t = jax.tree_util.tree_map(np.asarray, jpt)
    tree_d = jax.tree_util.tree_map(np.asarray, jpd)
    return {"jax": (jt, jd, jpt, jpd), "trees": (tree_t, tree_d),
            "torch": (build_model(cfg_t), build_model(cfg_d),
                      params_from_numpy(cfg_t, tree_t, "cpu"),
                      params_from_numpy(cfg_d, tree_d, "cpu"))}


@pytest.mark.parametrize("which", [0, 1], ids=["target", "drafter"])
def test_bridge_round_trip(pair, which):
    tree = pair["trees"][which]
    params = pair["torch"][2 + which]
    np.testing.assert_array_equal(params["embed"]["table"].numpy(),
                                  tree["embed"]["table"])
    np.testing.assert_array_equal(params["final_norm"]["scale"].numpy(),
                                  tree["final_norm"]["scale"])
    n = tree["layers"]["attn"]["q"]["w"].shape[0]
    assert len(params["layers"]) == n

    def walk(port, stacked, i, path):
        if isinstance(stacked, dict):
            assert set(port) == set(stacked), path
            for k in stacked:
                walk(port[k], stacked[k], i, f"{path}/{k}")
        else:
            np.testing.assert_array_equal(port.numpy(), stacked[i], err_msg=path)

    for i in range(n):
        walk(params["layers"][i], tree["layers"], i, f"layers[{i}]")


def test_paged_write_is_exact():
    rng = np.random.default_rng(0)
    NB, BS, Kv, D, B, Q, MB = 12, 4, 2, 8, 3, 5, 4
    table = np.zeros((B, MB), np.int32)
    table[0] = [3, 1, 7, 2]
    table[1] = [4, 5, 6, 8]                      # row 2 stays on the NULL block
    idx = np.array([2, 9, 0], np.int32)
    k_new = rng.standard_normal((B, Q, Kv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, Q, Kv, D)).astype(np.float32)
    k_new[2], v_new[2] = 0.0, 0.0                # NULL-block writes coincide
    zeros = np.zeros((NB, BS, Kv, D), np.float32)
    want = jax_paged_kv.write({"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)},
                              jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(table), jnp.asarray(idx))
    layer = {"k": torch.zeros(NB, BS, Kv, D), "v": torch.zeros(NB, BS, Kv, D)}
    got = paged_kv.write(layer, torch.from_numpy(k_new), torch.from_numpy(v_new),
                         torch.from_numpy(table), torch.from_numpy(idx))
    assert got["k"] is layer["k"]                # in place
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))


def _caches(jmodel, model, B, NB, BS, MB):
    table = np.zeros((B, MB), np.int32)
    for b in range(B - 1):                       # the last row: NULL block
        table[b] = np.arange(1 + b * MB, 1 + (b + 1) * MB)
    jc = jmodel.init_paged_cache(B, NB, BS, MB, dtype=jnp.float32)
    jc = {**jc, "block_table": jnp.asarray(table)}
    tc = model.init_paged_cache(B, NB, BS, MB, device="cpu")
    tc = {**tc, "block_table": torch.from_numpy(table)}
    return jc, tc


def _check_cache(jc, tc):
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    for name in ("k", "v"):
        want, got = np.asarray(jc[name]), tc[name].numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, **POOL_TOL)


@pytest.mark.parametrize("which", [0, 1], ids=["target", "drafter"])
def test_apply_on_paged_cache_matches_jax(pair, which):
    """A ragged prefill, then a verify-shaped Q=gamma+1 step, then a Q=1
    draft-shaped step, each with the round-level live bound."""
    jmodel, jparams = pair["jax"][which], pair["jax"][2 + which]
    model, params = pair["torch"][which], pair["torch"][2 + which]
    cfg = model.cfg
    B, NB, BS, MB = 3, 24, 4, 8
    jc, tc = _caches(jmodel, model, B, NB, BS, MB)
    rng = np.random.default_rng(1 + which)

    def step(jc, tc, Q, max_live):
        toks = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
        jl, jc, _ = jmodel.apply(jparams, jnp.asarray(toks), jc,
                                 max_live=max_live)
        tl, tc, _ = model.apply(params, torch.from_numpy(toks), tc,
                                max_live=max_live)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _check_cache(jc, tc)
        return jc, tc

    # ragged prefill: one bucket-padded pass from 0, rolled back per row
    jc, tc = step(jc, tc, 7, None)
    ragged = np.array([5, 7, 2], np.int32)
    jc = jax_paged_kv.rollback(jc, jnp.asarray(ragged))
    tc = paged_kv.rollback(tc, torch.from_numpy(ragged))
    jc, tc = step(jc, tc, 4, int(ragged.max()) + 4)          # gamma = 3 verify
    after = np.array([6, 9, 2], np.int32)
    jc = jax_paged_kv.rollback(jc, jnp.asarray(after))
    tc = paged_kv.rollback(tc, torch.from_numpy(after))
    step(jc, tc, 1, int(after.max()) + 1)                    # draft step


def test_logits_slice_last(pair):
    jmodel, jparams = pair["jax"][0], pair["jax"][2]
    model, params = pair["torch"][0], pair["torch"][2]
    jc, tc = _caches(jmodel, model, 3, 24, 4, 8)
    toks = np.random.default_rng(5).integers(0, 512, (3, 6)).astype(np.int32)
    jl, _, _ = jmodel.apply(jparams, jnp.asarray(toks), jc, logits_slice="last")
    tl, _, _ = model.apply(params, torch.from_numpy(toks), tc,
                           logits_slice="last")
    assert tuple(tl.shape) == (3, 1, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
