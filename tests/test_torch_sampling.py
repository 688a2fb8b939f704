"""Port parity for the sampling primitives: the key protocol
(``repro_torch.sampling.keys``), the token samplers
(``repro_torch.sampling.sampler``) and the stochastic acceptance rules
(``repro_torch.core.acceptance``) against ``repro``.

Given a ``JaxKey`` (tests/_jax_keys.py: ``jax.random``'s draws behind the
port's key protocol) the port's categorical, ``sample`` (greedy,
temperature, top-k, top-p), ``verify_stochastic`` and
``verify_tree_stochastic`` must give JAX's outputs exactly on the same
numpy inputs; a width-1 tree verify must equal the linear verify exactly.
With the port's own ``TorchKey``: one seed gives one sequence, and the
first emitted token's law is the target's (total variation below 0.03
for the linear rule and 0.02 for a width-3 tree over 20,000 rows of one
batched call, the thresholds of ``tests/test_acceptance.py`` and
``tests/test_tree_rounds.py``), and a drafter equal to the target has
every draft accepted."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_keys import JaxKey  # noqa: E402
from repro.core import acceptance as jax_acceptance  # noqa: E402
from repro.sampling import sampler as jax_sampler  # noqa: E402
from repro_torch.core import acceptance  # noqa: E402
from repro_torch.sampling import keys, sampler  # noqa: E402


def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# JAX's rules jitted: one compile per shape instead of one per eager op
JAX_VERIFY = jax.jit(jax_acceptance.verify_stochastic, static_argnums=4)
JAX_TREE_VERIFY = jax.jit(jax_acceptance.verify_tree_stochastic,
                          static_argnums=5)


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- keys
def test_torch_key_is_deterministic_and_splits_apart():
    a, b = keys.TorchKey(5), keys.TorchKey(5)
    for x, y in zip(a.split(3), b.split(3)):
        assert x.seed == y.seed
        torch.testing.assert_close(x.uniform((4, 7), 0.5), y.uniform((4, 7), 0.5),
                                   rtol=0, atol=0)
    children = [k.seed for k in a.split(4)] + [a.seed, keys.TorchKey(6).seed]
    assert len(set(children)) == len(children)
    # the first child of split(2) is the first of split(3): a stream
    assert a.split(2)[0].seed == a.split(3)[0].seed
    u = a.uniform((1000,), 0.25)
    assert u.dtype == torch.float32 and float(u.min()) >= 0.25 and float(u.max()) < 1
    g = a.gumbel((1000,), torch.float32)
    assert torch.isfinite(g).all() and abs(float(g.mean()) - 0.5772) < 0.15


@pytest.mark.parametrize("shape", [(5,), (3, 11), (2, 4, 512)])
def test_jax_key_draws_are_jax_random(shape):
    k = jax.random.PRNGKey(3)
    jk = JaxKey(k)
    _same(jk.uniform(shape, 1e-20), jax.random.uniform(k, shape, minval=1e-20))
    _same(jk.gumbel(shape, torch.float32), jax.random.gumbel(k, shape))
    for a, b in zip(jk.split(3), jax.random.split(k, 3)):
        np.testing.assert_array_equal(np.asarray(a.key), np.asarray(b))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(7,), (6, 33), (2, 3, 512)])
def test_categorical_matches_jax(seed, shape):
    x = _logits(seed, shape)
    k = jax.random.PRNGKey(seed + 10)
    got = keys.categorical(JaxKey(k), torch.from_numpy(x))
    assert got.dtype == torch.int32
    _same(got, jax.random.categorical(k, jnp.asarray(x), axis=-1))


# ---------------------------------------------------------------- sampler
SAMPLERS = [dict(greedy=True), dict(greedy=False),
            dict(greedy=False, temperature=0.5),
            dict(greedy=False, temperature=3.0, top_k=5),
            dict(greedy=False, top_p=0.8),
            dict(greedy=False, temperature=0.7, top_k=9, top_p=0.6),
            dict(greedy=False, top_p=0.01), dict(greedy=False, top_k=1)]


@pytest.mark.parametrize("cfg", SAMPLERS, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
@pytest.mark.parametrize("seed", range(3))
def test_sample_matches_jax(cfg, seed):
    x = _logits(seed, (16, 40))
    k = jax.random.PRNGKey(seed)
    got = sampler.sample(JaxKey(k), torch.from_numpy(x), sampler.SamplerConfig(**cfg))
    want = jax_sampler.sample(k, jnp.asarray(x), jax_sampler.SamplerConfig(**cfg))
    _same(got, want)


# ----------------------------------------------------- stochastic verify
def _verify_inputs(seed, B, G, V, same=False):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, G, V)) * 2).astype(np.float32)
    p = (rng.standard_normal((B, G + 1, V)) * 2).astype(np.float32)
    if same:
        p[:, :G] = q
    drafts = rng.integers(0, V, (B, G)).astype(np.int32)
    return drafts, q, p


@pytest.mark.parametrize("seed,B,G,V,temperature", [
    (0, 8, 4, 16, 1.0), (1, 5, 1, 7, 1.0), (2, 16, 3, 33, 0.7),
    (3, 4, 6, 512, 1.3), (4, 32, 2, 5, 1e-9)])
def test_verify_stochastic_matches_jax(seed, B, G, V, temperature):
    drafts, q, p = _verify_inputs(seed, B, G, V)
    k = jax.random.PRNGKey(seed)
    got = acceptance.verify_stochastic(JaxKey(k), torch.from_numpy(drafts),
                                       torch.from_numpy(q), torch.from_numpy(p),
                                       temperature)
    want = JAX_VERIFY(k, jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(p),
                      temperature)
    for name in want._fields:
        _same(getattr(got, name), getattr(want, name))
    assert 0 < int(got.n_accepted.sum()) or G == 1


def test_verify_stochastic_accepts_every_draft_of_the_target():
    drafts, q, p = _verify_inputs(5, 64, 4, 16, same=True)
    res = acceptance.verify_stochastic(keys.TorchKey(1), torch.from_numpy(drafts),
                                       torch.from_numpy(q), torch.from_numpy(p))
    assert int(res.n_accepted.min()) == 4
    np.testing.assert_array_equal(res.out_tokens[:, :4].numpy(), drafts)
    assert acceptance.empirical_alpha(res.n_accepted, 4).tolist() == [1.0] * 64


def _tree_inputs(seed, B, W, D, V):
    from repro_torch.core.tree import chain_tree
    rng = np.random.default_rng(seed)
    tree = chain_tree(W, D)
    q = (rng.standard_normal((B, W, D, V)) * 2).astype(np.float32)
    q[:, :, 0] = q[:, :1, 0]                     # one root distribution
    p = (rng.standard_normal((B, tree.span, V)) * 2).astype(np.float32)
    drafts = rng.integers(0, V, (B, W, D)).astype(np.int32)
    return drafts, q, p, np.asarray(tree.chain_slots, np.int32)


@pytest.mark.parametrize("seed,B,W,D,V,temperature", [
    (0, 8, 1, 3, 16, 1.0), (1, 8, 2, 3, 16, 1.0), (2, 12, 3, 1, 8, 1.0),
    (3, 6, 3, 4, 33, 0.8), (4, 4, 2, 2, 512, 1.0)])
def test_verify_tree_stochastic_matches_jax(seed, B, W, D, V, temperature):
    drafts, q, p, cs = _tree_inputs(seed, B, W, D, V)
    k = jax.random.PRNGKey(seed)
    got = acceptance.verify_tree_stochastic(
        JaxKey(k), torch.from_numpy(drafts), torch.from_numpy(q),
        torch.from_numpy(p), cs, temperature)
    want = JAX_TREE_VERIFY(k, jnp.asarray(drafts), jnp.asarray(q),
                           jnp.asarray(p), jnp.asarray(cs), temperature)
    for name in want._fields:
        _same(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("seed", range(3))
def test_width1_tree_verify_is_the_linear_verify(seed):
    """W = 1: the same splits, uniforms and epsilons as
    ``verify_stochastic``, so the same result exactly."""
    drafts, q, p, cs = _tree_inputs(seed, 64, 1, 4, 12)
    for key in (keys.TorchKey(seed), JaxKey(jax.random.PRNGKey(seed))):
        tree = acceptance.verify_tree_stochastic(
            key, torch.from_numpy(drafts), torch.from_numpy(q), torch.from_numpy(p), cs)
        lin = acceptance.verify_stochastic(
            key, torch.from_numpy(drafts[:, 0]), torch.from_numpy(q[:, 0]),
            torch.from_numpy(p))
        for name in lin._fields:
            torch.testing.assert_close(getattr(tree, name), getattr(lin, name),
                                       rtol=0, atol=0)
        assert int(tree.winner.max()) == 0


# ------------------------------------------------ losslessness, TorchKey
N_ROWS, V_SMALL = 20000, 8


def _tv(first, p_logits):
    emp = np.bincount(first.numpy(), minlength=V_SMALL) / len(first)
    want = torch.softmax(torch.from_numpy(p_logits), -1).numpy()
    return 0.5 * np.abs(emp - want).sum()


def test_linear_first_token_law_is_the_target():
    """20,000 rows of one batched call: drafts i.i.d. from q, the first
    emitted token (accepted draft or residual resample) ~ p."""
    q_log, p_log = _logits(11, (V_SMALL,)), _logits(12, (2, V_SMALL))
    kd, kv = keys.TorchKey(3).split()
    q = torch.from_numpy(q_log).expand(N_ROWS, 1, V_SMALL)
    drafts = keys.categorical(kd, q)
    res = acceptance.verify_stochastic(kv, drafts, q,
                                       torch.from_numpy(p_log).expand(N_ROWS, 2, V_SMALL))
    assert 0 < float(res.n_accepted.float().mean()) < 1
    tv = _tv(res.out_tokens[:, 0], p_log[0])
    assert tv < 0.03, tv


def test_tree_root_law_is_the_target():
    """Width 3, depth 1: W i.i.d. heads from q per row, recursive rejection
    at the root; the first emitted token ~ p."""
    W = 3
    q_log, p_log = _logits(21, (V_SMALL,)), _logits(22, (V_SMALL,))
    kh, kv = keys.TorchKey(4).split()
    heads = keys.categorical(kh, torch.from_numpy(q_log).expand(N_ROWS * W, V_SMALL))
    q = torch.from_numpy(q_log).expand(N_ROWS, W, 1, V_SMALL)
    p = torch.cat([torch.from_numpy(p_log)[None, None].expand(N_ROWS, 1, V_SMALL),
                   torch.zeros((N_ROWS, W, V_SMALL))], dim=1)
    res = acceptance.verify_tree_stochastic(
        kv, heads.reshape(N_ROWS, W, 1), q, p, np.arange(1, W + 1)[:, None])
    assert int(res.winner.max()) == W - 1
    tv = _tv(res.out_tokens[:, 0], p_log)
    assert tv < 0.02, tv
