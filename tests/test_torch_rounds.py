"""Port parity: one per-row speculative round (gamma=3, one row inactive)
and one AR round of the port's round core against ``repro.core.rounds``
on the same paged state of the ``llama3.2-1b`` smoke pair. Greedy paths:
tokens, lengths and n_accepted must be EXACTLY equal. Run once with the
smoke drafter (little acceptance) and once with the target as its own
drafter (full acceptance), so both ends of the commit are exercised."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jax_paged_kv  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import rounds as jax_rounds  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import rounds  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

GAMMA = 3
B, NB, BS, MB, T = 3, 32, 4, 8, 24
PROMPTS = (5, 8, 6)
ACTIVE = np.array([True, False, True])


@pytest.fixture(scope="module")
def pair():
    jcfg_t = jax_registry.smoke_config("llama3.2-1b")
    jcfg_d = jcfg_t.replace(num_layers=jcfg_t.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg_t), jax_build(jcfg_d)
    jpt, jpd = jt.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(7))
    cfg_t = registry.smoke_config("llama3.2-1b")
    cfg_d = cfg_t.replace(num_layers=cfg_t.num_layers - 1, name="draft")
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg_t), build_model(cfg_d),
                      params_from_numpy(cfg_t, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


def _states(pair, self_draft):
    """The same prefilled paged state in both packages: one padded prefill
    pass per model, rolled back to each row's prompt length - 1."""
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    if self_draft:
        jd, jpd, md, pd = jt, jpt, mt, pt
    rng = np.random.default_rng(4)
    Pmax = max(PROMPTS)
    tokens = np.zeros((B, T), np.int32)
    for b, P in enumerate(PROMPTS):
        tokens[b, :P] = rng.integers(0, 512, P)
    table = np.arange(1, 1 + B * MB, dtype=np.int32).reshape(B, MB)
    length = np.asarray(PROMPTS, np.int32)

    def jax_cache(m, p):
        c = {**m.init_paged_cache(B, NB, BS, MB, dtype=jnp.float32),
             "block_table": jnp.asarray(table)}
        _, c, _ = m.apply(p, jnp.asarray(tokens[:, :Pmax - 1]), c)
        return jax_paged_kv.rollback(c, jnp.asarray(length - 1))

    def port_cache(m, p):
        c = {**m.init_paged_cache(B, NB, BS, MB, device="cpu"),
             "block_table": torch.from_numpy(table)}
        _, c, _ = m.apply(p, torch.from_numpy(tokens[:, :Pmax - 1]), c)
        return paged_kv.rollback(c, torch.from_numpy(length - 1))

    js = jax_rounds.RoundState(
        tokens=jnp.asarray(tokens), length=jnp.asarray(length),
        dcache=jax_cache(jd, jpd), tcache=jax_cache(jt, jpt),
        active=jnp.asarray(ACTIVE), n_rounds=jnp.zeros((), jnp.int32),
        n_accepted=jnp.zeros((B,), jnp.int32), n_drafted=jnp.zeros((), jnp.int32))
    ts = rounds.RoundState(
        tokens=torch.from_numpy(tokens), length=torch.from_numpy(length),
        dcache=port_cache(md, pd), tcache=port_cache(mt, pt),
        active=torch.from_numpy(ACTIVE), n_rounds=torch.zeros((), dtype=torch.int32),
        n_accepted=torch.zeros((B,), dtype=torch.int32),
        n_drafted=torch.zeros((), dtype=torch.int32))
    return (jt, jd, jpt, jpd, js), (mt, md, pt, pd, ts)


def _assert_same(ts, js, fields):
    for name in fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    for c in ("tcache", "dcache"):
        np.testing.assert_array_equal(getattr(ts, c)["index"].numpy(),
                                      np.asarray(getattr(js, c)["index"]))


@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["smoke_drafter", "target_drafts"])
def test_spec_round_then_ar_round_match_jax(pair, self_draft):
    (jt, jd, jpt, jpd, js), (mt, md, pt, pd, ts) = _states(pair, self_draft)
    js = jax_rounds.spec_round(jt, jd, jpt, jpd, js,
                               jax_rounds.RoundSpec(gamma=GAMMA, commit="per_row"))
    ts = rounds.spec_round(mt, md, pt, pd, ts, rounds.RoundSpec(gamma=GAMMA))
    _assert_same(ts, js, ("tokens", "length", "n_accepted", "n_rounds",
                          "n_drafted"))
    # the inactive row committed nothing
    assert int(ts.length[1]) == PROMPTS[1]
    if self_draft:
        np.testing.assert_array_equal(ts.n_accepted.numpy(),
                                      np.where(ACTIVE, GAMMA, 0))

    js = jax_rounds.ar_round(jt, jpt, js)
    ts = rounds.ar_round(mt, pt, ts)
    _assert_same(ts, js, ("tokens", "length", "n_rounds"))
