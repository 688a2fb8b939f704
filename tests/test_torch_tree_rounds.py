"""Port parity for paged greedy tree speculation: the cache primitives of
a tree commit (``copy_blocks``, ``compact_positions``), greedy tree
verification, and whole ``PagedTreeRound`` runs of the ``llama3.2-1b``
smoke pair against ``repro`` on the same weights and inputs.

Greedy paths compare tokens, lengths and winners EXACTLY; pools moved by
the cache primitives compare bit for bit. Both block allocators must pass
``audit()`` after every round. The port's tree round must also reproduce
the ``per_row_greedy_ring`` golden (tests/goldens/rounds_parity.json), as
``tests/test_tree_rounds.py`` does for the JAX round, and a width-1 tree
round must commit what the port's linear round commits."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import paged_kv as jax_paged_kv  # noqa: E402
from repro.cache.paged_kv import BlockAllocator as JaxAllocator  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import acceptance as jax_acceptance  # noqa: E402
from repro.core import rounds as jax_rounds  # noqa: E402
from repro.core.tree import chain_tree as jax_chain_tree  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.cache.paged_kv import BlockAllocator  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import acceptance, rounds  # noqa: E402
from repro_torch.core.tree import chain_tree  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

PARITY = json.loads((pathlib.Path(__file__).parent / "goldens"
                     / "rounds_parity.json").read_text())
GAMMA = PARITY["meta"]["gamma"]
BS, MB, T = 4, 12, 48


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


# ---------------------------------------------------------- cache primitives
def _pools(seed, L=2, NB=12, Kv=2, D=8):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((L, NB, BS, Kv, D)).astype(np.float32)
            for n in ("k", "v")}


def test_copy_blocks_matches_jax_bit_exact():
    pools = _pools(0)
    pairs = [(3, 7), (3, 8), (5, 1)]
    got = paged_kv.copy_blocks({n: torch.from_numpy(a.copy())
                                for n, a in pools.items()}, pairs)
    want = jax_paged_kv.copy_blocks({n: jnp.asarray(a)
                                     for n, a in pools.items()}, pairs)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    assert paged_kv.copy_blocks(got, []) is got


@pytest.mark.parametrize("winner", [(0, 1), (1, 1), (1, 0)])
def test_compact_positions_matches_jax_bit_exact(winner):
    """The commit-by-compaction of a W=2, depth-3 tree: winner slots are
    scattered past the tail and partly overlap the destinations (slot 1
    of chain 0 is already home), so a move that scatters before it has
    gathered would differ."""
    pools = _pools(1)
    table = np.array([[2, 5, 9, 0], [7, 3, 11, 4]], np.int32)
    length = np.array([3, 6], np.int32)
    cs = chain_tree(2, GAMMA).chain_slots
    src = (length - 1)[:, None] + cs[np.asarray(winner)]
    dst = length[:, None] + np.arange(GAMMA, dtype=np.int32)
    got = paged_kv.compact_positions(
        {n: torch.from_numpy(a.copy()) for n, a in pools.items()},
        torch.from_numpy(table), torch.from_numpy(src), torch.from_numpy(dst))
    want = jax_paged_kv.compact_positions(
        {n: jnp.asarray(a) for n, a in pools.items()}, jnp.asarray(table),
        jnp.asarray(src), jnp.asarray(dst))
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


# ------------------------------------------------------------ tree verify
@pytest.mark.parametrize("W,D", [(1, 3), (2, 3), (3, 2)])
def test_verify_tree_greedy_matches_jax(W, D):
    """Random target logits with planted ties (first maximum wins) and
    drafts that follow the target's argmax for a row-dependent number of
    levels, so rows accept 0..D tokens, some chains tie (chain 0 wins)."""
    rng = np.random.default_rng(W * 10 + D)
    B, V = 6, 64
    shape = chain_tree(W, D)
    logits = rng.standard_normal((B, shape.span, V)).astype(np.float32)
    logits[:, ::2, 5] = logits[:, ::2].max(axis=-1) + 1.0
    logits[:, ::2, 9] = logits[:, ::2, 5]             # tie: 5 must win
    slots = np.concatenate([np.zeros((W, 1), np.int32), shape.chain_slots], 1)
    tgt = logits.argmax(-1)                           # [B, span]
    drafts = rng.integers(0, V, (B, W, D)).astype(np.int32)
    for b in range(B):
        for w in range(W):                    # even rows: all chains tie
            keep = (b + (w if b % 2 else 0)) % (D + 1)
            drafts[b, w, :keep] = tgt[b, slots[w, :keep]]
    got = acceptance.verify_tree_greedy(torch.from_numpy(drafts),
                                        torch.from_numpy(logits),
                                        shape.chain_slots)
    want = jax_acceptance.verify_tree_greedy(
        jnp.asarray(drafts), jnp.asarray(logits),
        jnp.asarray(jax_chain_tree(W, D).chain_slots))
    for name in ("winner", "n_accepted", "out_tokens", "n_emitted"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert len(set(got.n_accepted.tolist())) > 1
    assert W == 1 or int(got.winner.max()) > 0


# ----------------------------------------------------------- paged rounds
def _states(pair, prompts, nb=64, with_jax=True):
    """The same prefilled paged state in both packages (the JAX one only
    when ``with_jax``): each row's first P-1 tokens prefilled through a
    one-row view of the caches (its own table row, index 0, the pools
    shared), as the serving path does."""
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    B = len(prompts)
    tokens = np.zeros((B, T), np.int32)
    for b, p in enumerate(prompts):
        tokens[b, :len(p)] = p
    length = np.asarray([len(p) for p in prompts], np.int32)
    allocs = []
    for A in (JaxAllocator, BlockAllocator):
        at, ad = A(nb, BS, MB, B), A(nb, BS, MB, B)
        for b in range(B):
            assert at.ensure(b, int(length[b])) and ad.ensure(b, int(length[b]))
        allocs.append((at, ad))

    def jax_cache(m, p, alloc):
        c = {**m.init_paged_cache(B, nb, BS, MB, dtype=jnp.float32),
             "block_table": alloc.device_table()}
        for b in range(B):
            view = {**c, "block_table": c["block_table"][b:b + 1],
                    "index": jnp.zeros((1,), jnp.int32)}
            _, view, _ = m.apply(p, jnp.asarray(tokens[b:b + 1, :length[b] - 1]),
                                 view)
            c = {**c, "k": view["k"], "v": view["v"]}
        return {**c, "index": jnp.asarray(length - 1)}

    def port_cache(m, p, alloc):
        c = {**m.init_paged_cache(B, nb, BS, MB, device="cpu"),
             "block_table": alloc.device_table("cpu")}
        for b in range(B):
            m.apply(p, torch.from_numpy(tokens[b:b + 1, :length[b] - 1]),
                    {**c, "block_table": c["block_table"][b:b + 1],
                     "index": torch.zeros((1,), dtype=torch.int32)})
        return {**c, "index": torch.from_numpy(length - 1)}

    (jat, jad), (at, ad) = allocs
    ts = rounds.RoundState(
        tokens=torch.from_numpy(tokens), length=torch.from_numpy(length),
        dcache=port_cache(md, pd, ad), tcache=port_cache(mt, pt, at),
        active=torch.ones((B,), dtype=torch.bool),
        n_rounds=torch.zeros((), dtype=torch.int32),
        n_accepted=torch.zeros((B,), dtype=torch.int32),
        n_drafted=torch.zeros((), dtype=torch.int32))
    if not with_jax:
        return ts, at, ad
    js = jax_rounds.RoundState(
        tokens=jnp.asarray(tokens), length=jnp.asarray(length),
        dcache=jax_cache(jd, jpd, jad), tcache=jax_cache(jt, jpt, jat),
        active=jnp.ones((B,), bool), n_rounds=jnp.zeros((), jnp.int32),
        n_accepted=jnp.zeros((B,), jnp.int32),
        n_drafted=jnp.zeros((), jnp.int32))
    return (js, jat, jad), (ts, at, ad)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, P).astype(np.int32) for P in lens]


@pytest.mark.parametrize("W", [1, 2])
def test_paged_tree_round_matches_jax(pair, W):
    """Ragged rows, four rounds: tokens, lengths, accepted counts and the
    caches' indices equal JAX's after every round, and the four
    allocators' censuses balance."""
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    (js, jat, jad), (ts, at, ad) = _states(pair, _prompts(4, (5, 8, 6)))
    jspec = jax_rounds.RoundSpec(gamma=GAMMA, greedy=True, commit="per_row",
                                 policy=jax_rounds.make_policy("tree", W),
                                 fused_verify=False)
    spec = rounds.RoundSpec(gamma=GAMMA, policy=rounds.make_policy("tree", W))
    jrnd = jax_rounds.PagedTreeRound(jt, jd, jspec, jat, jad)
    rnd = rounds.PagedTreeRound(mt, md, spec, at, ad)
    for _ in range(4):
        js = jrnd(jpt, jpd, js)
        ts = rnd(pt, pd, ts)
        for name in ("tokens", "length", "n_accepted", "n_rounds", "n_drafted"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=name)
        for c in ("tcache", "dcache"):
            np.testing.assert_array_equal(getattr(ts, c)["index"].numpy(),
                                          np.asarray(getattr(js, c)["index"]))
            np.testing.assert_array_equal(getattr(ts, c)["block_table"].numpy(),
                                          np.asarray(getattr(js, c)["block_table"]))
        assert at.audit() == {k: jat.audit()[k] for k in ("free", "live")}
        assert ad.audit() == {k: jad.audit()[k] for k in ("free", "live")}


def test_paged_tree_greedy_matches_parity_golden(pair):
    """The port's paged CoW tree round reproduces the committed
    rounds-parity per-row goldens token for token."""
    mt, md, pt, pd = pair["torch"]
    g = PARITY["per_row_greedy_ring"]
    P, new = 6, PARITY["meta"]["max_new"]
    prompts = list(np.random.default_rng(1).integers(0, 512, (4, P))
                   .astype(np.int32))
    st, at, ad = _states(pair, prompts, nb=96, with_jax=False)
    rnd = rounds.PagedTreeRound(mt, md, rounds.RoundSpec(
        gamma=GAMMA, policy=rounds.make_policy("tree", 2)), at, ad)
    while int(st.length.min()) < P + new:
        st = rnd(pt, pd, st)
        at.audit()
        ad.audit()
    np.testing.assert_array_equal(st.tokens[:, :P + new].numpy(),
                                  np.asarray(g["tokens"]))


@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["smoke_drafter", "target_drafts"])
def test_width1_tree_round_is_the_linear_round(pair, self_draft):
    """A width-1 tree round (one chain, tree-attention verify, identity
    compaction) commits exactly what the linear round commits, and leaves
    the same drafter KV behind."""
    mt, md, pt, pd = pair["torch"]
    if self_draft:
        md, pd = mt, pt
    pair = {"jax": pair["jax"], "torch": (mt, md, pt, pd)}
    prompts = _prompts(5, (5, 8, 6))
    lin, _, _ = _states(pair, prompts, with_jax=False)
    t1, _, _ = _states(pair, prompts, with_jax=False)
    lin = rounds.spec_round(mt, md, pt, pd, lin, rounds.RoundSpec(gamma=GAMMA))
    t1 = rounds.spec_round(mt, md, pt, pd, t1, rounds.RoundSpec(
        gamma=GAMMA, policy=rounds.make_policy("tree", 1)))
    for name in ("tokens", "length", "n_accepted"):
        np.testing.assert_array_equal(getattr(t1, name).numpy(),
                                      getattr(lin, name).numpy(), err_msg=name)
    for n in ("k", "v"):
        np.testing.assert_allclose(t1.dcache[n].numpy(), lin.dcache[n].numpy(),
                                   atol=1e-5, rtol=1e-5)
    if self_draft:
        np.testing.assert_array_equal(lin.n_accepted.numpy(), [GAMMA] * 3)


# ------------------------------------------------------------------ gates
@pytest.mark.parametrize("width,gamma", [(10, 4), (5, 7), (31, 1)])
def test_round_spec_rejects_a_span_over_31(width, gamma):
    with pytest.raises(ValueError, match="span"):
        rounds.RoundSpec(gamma=gamma, policy=rounds.make_policy("tree", width))


def test_make_policy_gates():
    with pytest.raises(ValueError, match="width"):
        rounds.make_policy("tree", 0)
    with pytest.raises(ValueError, match="unknown"):
        rounds.make_policy("beam")
    # W=1 at any gamma up to 30 is a valid (degenerate-linear) tree
    rounds.RoundSpec(gamma=30, policy=rounds.make_policy("tree", 1))
    with pytest.raises(ValueError, match="PagedTreeRound needs"):
        rounds.PagedTreeRound(None, None, rounds.RoundSpec(), None, None)
