"""The split computation of the bf16 paged and tree attention kernels, and
their launch plan, on the CPU.

``ref.paged_split_ref`` is the kernels' split walk in plain PyTorch: fixed
chunks of keys from key 0, a partial per chunk, the partials merged in chunk
order. It is held against the port's ``attn_paged`` / ``attn_tree``, the JAX
package's jnp oracles and its Pallas kernels in interpret mode, on the same
seeded numpy inputs, fp32, to atol=rtol=1e-5 (the frameworks sum in other
orders). Its rows must not depend on Q (bit-equal), and its bf16-weights
mode (P rounded to bf16 before the value product, as the tensor cores take
it) must stay within ``chip_smoke.py``'s bf16 tolerance. The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``, which also checks the bit-equalities there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_flash_attention as jax_paged_kernel  # noqa: E402
from repro.kernels.tree_attention import tree_flash_attention as jax_tree_kernel  # noqa: E402
from repro.models.attention import attn_paged as jax_attn_paged  # noqa: E402
from repro.models.attention import attn_tree as jax_attn_tree  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.ref import live_keys, paged_split_ref  # noqa: E402
from repro_torch.models.attention import attn_paged, attn_tree  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CARD_BF16_TOL = dict(atol=1e-2, rtol=1e-2)   # chip_smoke.py's bf16 tolerance
IRREGULAR = (0, 0, 1, 1, 2, 4)               # root -> {1, 2}; 1 -> {3, 4}; ...


def _pool(seed, B, Q, H, Kv, BS, MB, D=16, dtype=np.float32):
    """Seeded q and pools; each row owns MB private blocks, except row 2,
    which sits on the NULL block 0 (a frozen serving slot)."""
    rng = np.random.default_rng(seed)
    NB = B * MB + 2
    q = rng.standard_normal((B, Q, H, D)).astype(dtype)
    k = rng.standard_normal((NB, BS, Kv, D)).astype(dtype)
    v = rng.standard_normal((NB, BS, Kv, D)).astype(dtype)
    table = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    table = table.astype(np.int32)
    if B > 2:
        table[2] = 0
    return q, k, v, table


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ragged rows whose contexts span several 8-key and two 64-key chunks
INDEX = np.asarray([70, 11, 40], np.int32)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("Q", [1, 5])
@pytest.mark.parametrize("BS", [4, 8, 16])
def test_split_matches_attn_paged_jax_and_the_pallas_kernel(BS, Q, window):
    MB = -(-(int(INDEX.max()) + Q) // BS)
    q, k, v, table = _pool(BS * 10 + Q, 3, Q, 8, 2, BS, MB)
    want = attn_paged(*_t(q, k, v, table, INDEX), window=window).numpy()
    for chunk in (8, 64):
        got = paged_split_ref(*_t(q, k, v, table, INDEX), window=window,
                              chunk=chunk).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    args = _j(q, k, v, table, INDEX)
    np.testing.assert_allclose(
        got, np.asarray(jax_attn_paged(*args, window=window)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_kernel(*args, window=window, interpret=True)),
        **TOL)


@pytest.mark.parametrize("max_live", [6, 30, 75])
def test_split_keeps_the_max_live_cap(max_live):
    """The cap truncates the walk at whole pages, below some rows' own
    index + Q too, exactly as the oracle and the Pallas kernel do."""
    BS, Q = 4, 3
    q, k, v, table = _pool(max_live, 3, Q, 8, 2, BS, 20)
    got = paged_split_ref(*_t(q, k, v, table, INDEX), max_live=max_live,
                          chunk=8).numpy()
    args = _j(q, k, v, table, INDEX)
    np.testing.assert_allclose(
        got, np.asarray(jax_attn_paged(*args, max_live=max_live)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_kernel(*args, max_live=max_live,
                                         interpret=True)), **TOL)


@pytest.mark.parametrize("start", [0, 24, 61, 112])
@pytest.mark.parametrize("BS", [4, 16])
def test_prefill_chunk_matches_jax_and_the_whole_call(BS, start):
    """A prefill chunk as the chunked serving path launches it: B=1, Q=C
    queries from ``start`` over a shuffled table wider than the live keys,
    the live bound from the index. The plain version and the split walk
    match the jnp oracle and the Pallas kernel, and the split walk's rows
    are bit-equal to the same rows of one whole call of start+C queries
    from 0 over a table just wide enough (``chip_smoke.py`` checks the
    same of the kernel on the card)."""
    C, MB = 16, 128 // BS
    q, k, v, table = _pool(BS + start, 1, C, 8, 2, BS, MB)
    idx = np.asarray([start], np.int32)
    want = np.asarray(jax_attn_paged(*_j(q, k, v, table, idx)))
    np.testing.assert_allclose(attn_paged(*_t(q, k, v, table, idx)).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(
        np.asarray(jax_paged_kernel(*_j(q, k, v, table, idx), interpret=True)),
        want, **TOL)
    got = paged_split_ref(*_t(q, k, v, table, idx), chunk=8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    S = start + C
    qw = np.random.default_rng(start).standard_normal(
        (1, S, 8, q.shape[3])).astype(np.float32)
    qw[:, start:] = q
    whole = paged_split_ref(*_t(qw, k, v, table[:, :-(-S // BS)],
                                np.zeros(1, np.int32)), chunk=8)
    assert torch.equal(whole[:, start:], got)


TREES = [("chain_tree(2,4)", 4, None), ("chain_tree(2,4)", 16, 3),
         ("chain_tree(5,6)", 4, None), ("chain_tree(5,6)", 16, 3),
         ("irregular", 8, None), ("irregular", 8, 2)]


def _shape(name):
    if name == "irregular":
        return tree.TreeShape(parents=IRREGULAR)
    w, d = (int(x) for x in name[len("chain_tree("):-1].split(","))
    return tree.chain_tree(w, d)


@pytest.mark.parametrize("name,BS,window", TREES)
def test_split_tree_matches_attn_tree_jax_and_the_pallas_kernel(name, BS, window):
    """Spans 9 and 31 (bit 30 of the ancestor masks) and an irregular tree,
    with a window folded over the depth gap."""
    shape = _shape(name)
    MB = -(-(int(INDEX.max()) + shape.span) // BS)
    q, k, v, table = _pool(shape.span * 10 + BS, 3, shape.span, 8, 2, BS, MB)
    tree_args = (shape.depths, shape.bits)
    want = attn_tree(*_t(q, k, v, table, INDEX, *tree_args), window=window)
    for chunk in (8, 64):
        got = paged_split_ref(*_t(q, k, v, table, INDEX), depths=shape.depths,
                              bits=shape.bits, window=window, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    args = _j(q, k, v, table, INDEX, *tree_args)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_attn_tree(*args, window=window)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_tree_kernel(*args, window=window,
                                                interpret=True)), **TOL)


@pytest.mark.parametrize("p_bf16", [False, True])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("chunk", [8, 64])
def test_split_rows_do_not_depend_on_q(chunk, window, p_bf16):
    """A Q=5 verify and Q=1 steps at the same positions, on the same pool,
    each with the serving path's live bound max(index) + Q: the rows they
    share are bit-equal, though the verify walks further."""
    BS, Q = 8, 5
    q, k, v, table = _pool(chunk + Q, 3, Q, 8, 2, BS, 10)
    tq, tk, tv, tt = _t(q, k, v, table)
    idx = torch.from_numpy(INDEX)
    kw = dict(window=window, chunk=chunk, p_bf16=p_bf16)
    verify = paged_split_ref(tq, tk, tv, tt, idx, max_live=int(idx.max()) + Q, **kw)
    for i in range(Q):
        step = paged_split_ref(tq[:, i:i + 1], tk, tv, tt, idx + i,
                               max_live=int(idx.max()) + i + 1, **kw)
        assert torch.equal(step[:, 0], verify[:, i])


@pytest.mark.parametrize("chunk", [8, 64])
def test_width1_tree_split_is_bit_equal_to_the_causal_split(chunk):
    shape = tree.chain_tree(1, 4)
    q, k, v, table = _pool(chunk, 3, shape.span, 8, 2, 4, 20)
    args = _t(q, k, v, table, INDEX)
    causal = paged_split_ref(*args, chunk=chunk)
    width1 = paged_split_ref(*args, depths=shape.depths, bits=shape.bits,
                             chunk=chunk)
    assert torch.equal(causal, width1)


def _bf16_pool(seed, B, Q, H, Kv, D, BS=16, MB=16):
    """chip_smoke.py's attention inputs, bf16-valued, held in fp32."""
    q, k, v, table = _pool(seed, B, Q, H, Kv, BS, MB, D=D)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float() for a in (q, k, v))
    return q, k, v, torch.from_numpy(table)


@pytest.mark.parametrize("Q", [1, 5])
@pytest.mark.parametrize("H,Kv,D", [(24, 8, 128), (32, 8, 64), (10, 1, 256),
                                    (4, 1, 256), (8, 4, 48), (4, 2, 48),
                                    (4, 2, 32)])
def test_bf16_weights_stay_within_the_card_tolerance(H, Kv, D, Q):
    """Rounding P to bf16 (the PV operand of the kernel's tensor cores)
    keeps the output within chip_smoke.py's bf16 tolerance of the fp32
    plain version, at the Llama-3.2-3B and -1B head geometries, the
    RecurrentGemma pair's (D = 256) and chip_smoke.py's ragged rows (one
    on the NULL block)."""
    q, k, v, table = _bf16_pool(H + Q, 4, Q, H, Kv, D)
    idx = torch.tensor([37, 150, 11, 200], dtype=torch.int32)
    max_live = int(idx.max()) + Q
    got = paged_split_ref(q, k, v, table, idx, max_live=max_live, p_bf16=True)
    want = pa.plain(q, k, v, table, idx, max_live=max_live)
    torch.testing.assert_close(got, want, **CARD_BF16_TOL)


def test_bf16_weights_tree_stays_within_the_card_tolerance():
    shape = tree.chain_tree(2, 4)
    q, k, v, table = _bf16_pool(9, 4, shape.span, 24, 8, 128)
    idx = torch.tensor([37, 150, 11, 200], dtype=torch.int32)
    d, b = torch.from_numpy(shape.depths), torch.from_numpy(shape.bits)
    got = paged_split_ref(q, k, v, table, idx, depths=d, bits=b, p_bf16=True)
    want = attn_tree(q, k, v, table, idx, d, b)
    torch.testing.assert_close(got, want, **CARD_BF16_TOL)


# ------------------------------------------------------------------- plan
def _check_plan(dtype, B, Q, Kv, gq, D, BS, MB, index, max_live):
    p = pa.plan(dtype, B, Q, Kv * gq, Kv, D, BS, MB)
    n_rows = Q * gq
    assert p.row_tile == pa.ROW_TILE
    owner = np.zeros(n_rows, np.int64)
    for tile in range(p.row_tiles):
        assert tile * p.row_tile < n_rows            # no tile without rows
        owner[tile * p.row_tile:(tile + 1) * p.row_tile] += 1
    assert (owner == 1).all()
    live = live_keys(index, Q, BS, MB, max_live)
    assert (live >= BS).all() and (live <= MB * BS).all()
    if dtype == torch.float32:
        assert (p.chunks, p.workspace) == (1, 0)
        return p
    # the grid's chunks, keys [c * CHUNK, (c + 1) * CHUNK), cover every live
    # key of every row; the blocks that run are those starting below it
    assert int(live.max()) <= p.chunks * pa.CHUNK < MB * BS + pa.CHUNK
    for n in live.tolist():
        running = [c for c in range(p.chunks) if c * pa.CHUNK < n]
        assert len(running) == -(-n // pa.CHUNK)
    assert p.workspace == B * Kv * n_rows * p.chunks * (D + 2)
    return p


def test_plan_covers_every_row_tile_and_live_chunk_once():
    """Over ragged calls: the row tiles cover the Q * gq rows once, the
    chunks cover every live key once, and a chunk's keys are the same at
    every Q (plan reads nothing of the card, so no SM count can move
    them either)."""
    hyp = pytest.importorskip("hypothesis")   # requirements-test.txt
    st = hyp.strategies

    @hyp.settings(max_examples=200, deadline=None)
    @hyp.given(dtype=st.sampled_from([torch.float32, torch.bfloat16]),
               B=st.integers(1, 6), Q=st.integers(1, 128),
               Kv=st.integers(1, 8), gq=st.integers(1, 6),
               D=st.sampled_from([32, 48, 64, 128, 256]),
               BS=st.sampled_from([4, 8, 16, 32]),
               MB=st.integers(1, 64), data=st.data())
    def check(dtype, B, Q, Kv, gq, D, BS, MB, data):
        index = np.asarray(data.draw(st.lists(
            st.integers(0, MB * BS), min_size=B, max_size=B)))
        max_live = data.draw(st.one_of(st.none(), st.integers(1, MB * BS + 8)))
        p = _check_plan(dtype, B, Q, Kv, gq, D, BS, MB, index, max_live)
        other = _check_plan(dtype, B, data.draw(st.integers(1, 128)), Kv, gq,
                            D, BS, MB, index, max_live)
        assert (other.chunks, other.row_tile) == (p.chunks, p.row_tile)

    check()


@pytest.mark.parametrize("Q,H,D,MB,tiles,chunks", [
    (1, 24, 128, 16, 1, 4), (1, 32, 64, 16, 1, 4),        # drafter / AR decode
    (5, 24, 128, 16, 1, 4), (5, 32, 64, 16, 2, 4),        # gamma + 1 verify
    (127, 24, 128, 16, 24, 4), (127, 32, 64, 16, 32, 4),  # bucketed prefill
    (9, 24, 128, 24, 2, 6), (31, 24, 128, 16, 6, 4)])     # tree spans 9, 31
def test_plan_at_the_chip_smoke_shapes(Q, H, D, MB, tiles, chunks):
    """B=4, 8 kv-heads, block size 16: the decode and verify calls run one
    or two row tiles of 16 over 4 chunks of 64 keys (the table's 256 keys;
    6 for the tree trace's 24-block table): 4 * 8 * 4 = 128 blocks for a
    decode call. fp32 keeps one walk per row tile."""
    p = pa.plan(torch.bfloat16, 4, Q, H, 8, D, 16, MB)
    assert (p.row_tile, p.row_tiles, p.chunks) == (16, tiles, chunks)
    assert p.row_tiles * p.chunks * 8 * 4 >= 128
    assert p.workspace == 4 * 8 * Q * (H // 8) * chunks * (D + 2)
    f = pa.plan(torch.float32, 4, Q, H, 8, D, 16, MB)
    assert (f.row_tiles, f.chunks, f.workspace) == (tiles, 1, 0)


@pytest.mark.parametrize("H,D,MB,tiles,chunks", [
    (24, 128, 64, 12, 16), (32, 64, 64, 16, 16),      # the chunked serve
    (24, 128, 256, 12, 64), (32, 64, 256, 16, 64)])   # chip_smoke's cases
def test_plan_at_the_prefill_chunk_shapes(H, D, MB, tiles, chunks):
    """B=1, Q=64 (a prefill chunk), 8 kv-heads, block size 16: 12 or 16
    row tiles over every 64-key chunk of the table, whatever the chunk's
    start (the live bound is read on the card)."""
    p = pa.plan(torch.bfloat16, 1, 64, H, 8, D, 16, MB)
    assert (p.row_tile, p.row_tiles, p.chunks) == (16, tiles, chunks)
    assert p.workspace == 8 * 64 * (H // 8) * chunks * (D + 2)


# ------------------------------------------------------------ head_dim 256
@pytest.mark.parametrize("Q", [1, 5])
@pytest.mark.parametrize("H,Kv", [(10, 1), (4, 1)])   # recurrentgemma-2b, -draft
def test_split_matches_jax_and_the_pallas_kernel_at_head_dim_256(H, Kv, Q):
    """The bf16 kernels' split walk at RecurrentGemma's D = 256 against
    ``attn_paged``, the jnp oracle and the interpret-mode Pallas kernel;
    its Q = 5 rows bit-equal to Q = 1 steps."""
    BS = 8
    MB = -(-(int(INDEX.max()) + Q) // BS)
    q, k, v, table = _pool(H * 10 + Q, 3, Q, H, Kv, BS, MB, D=256)
    args = _t(q, k, v, table, INDEX)
    got = paged_split_ref(*args, chunk=8).numpy()
    np.testing.assert_allclose(got, attn_paged(*args).numpy(), **TOL)
    jargs = _j(q, k, v, table, INDEX)
    np.testing.assert_allclose(got, np.asarray(jax_attn_paged(*jargs)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_kernel(*jargs, interpret=True)), **TOL)
    tq, tk, tv, tt, idx = args
    verify = paged_split_ref(tq, tk, tv, tt, idx, max_live=int(idx.max()) + Q)
    for i in range(Q):
        step = paged_split_ref(tq[:, i:i + 1], tk, tv, tt, idx + i,
                               max_live=int(idx.max()) + i + 1)
        assert torch.equal(step[:, 0], verify[:, i])


@pytest.mark.parametrize("Q,H,tiles", [(1, 10, 1), (5, 10, 4), (1, 4, 1),
                                       (5, 4, 2)])
def test_plan_at_the_hybrid_ring_shapes(Q, H, tiles):
    """The hybrid cached path at chip_smoke.py's full width: B = 2, one
    kv-head, D = 256, a 144-slot ring read as 9 pages of 16 (3 chunks of
    64 keys); fp32 keeps one walk per row tile."""
    p = pa.plan(torch.bfloat16, 2, Q, H, 1, 256, 16, 9)
    assert (p.row_tile, p.row_tiles, p.chunks) == (16, tiles, 3)
    assert p.workspace == 2 * Q * H * 3 * (256 + 2)
    f = pa.plan(torch.float32, 2, Q, H, 1, 256, 16, 9)
    assert (f.row_tiles, f.chunks, f.workspace) == (tiles, 1, 0)


# ----------------------------------------------------- head dims 32 and 48
# the bench pair of benchmarks/common.py: its target 8 / 4 heads of 48, its
# drafter 4 / 2 heads of 48 (``replace`` keeps the target's derived
# head_dim); d 128 over 4 / 2 at d / H = 32
PAIR_GEOMS = [(8, 4, 48), (4, 2, 48), (4, 2, 32)]


@pytest.mark.parametrize("Q", [1, 5])
@pytest.mark.parametrize("H,Kv,D", PAIR_GEOMS)
def test_split_matches_jax_and_the_pallas_kernel_at_head_dims_32_and_48(H, Kv, D, Q):
    """The bf16 kernels' split walk at D 48 and 32 against ``attn_paged``,
    the jnp oracle and the interpret-mode Pallas kernel; its Q = 5 rows
    bit-equal to Q = 1 steps, in both weight modes."""
    BS = 8
    MB = -(-(int(INDEX.max()) + Q) // BS)
    q, k, v, table = _pool(H * 10 + D + Q, 3, Q, H, Kv, BS, MB, D=D)
    args = _t(q, k, v, table, INDEX)
    got = paged_split_ref(*args, chunk=8).numpy()
    np.testing.assert_allclose(got, attn_paged(*args).numpy(), **TOL)
    jargs = _j(q, k, v, table, INDEX)
    np.testing.assert_allclose(got, np.asarray(jax_attn_paged(*jargs)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_kernel(*jargs, interpret=True)), **TOL)
    tq, tk, tv, tt, idx = args
    for p_bf16 in (False, True):
        verify = paged_split_ref(tq, tk, tv, tt, idx, max_live=int(idx.max()) + Q,
                                 p_bf16=p_bf16)
        for i in range(Q):
            step = paged_split_ref(tq[:, i:i + 1], tk, tv, tt, idx + i,
                                   max_live=int(idx.max()) + i + 1, p_bf16=p_bf16)
            assert torch.equal(step[:, 0], verify[:, i])


@pytest.mark.parametrize("name,BS,window", [("chain_tree(2,4)", 4, None),
                                            ("chain_tree(2,4)", 16, 3),
                                            ("irregular", 8, None)])
@pytest.mark.parametrize("H,Kv,D", PAIR_GEOMS)
def test_split_tree_matches_jax_at_head_dims_32_and_48(H, Kv, D, name, BS, window):
    """The tree policy at D 48 and 32: the split walk against ``attn_tree``,
    the jnp oracle and the interpret-mode Pallas tree kernel; a width-1
    tree bit-equal to the causal split; the bf16-weights mode within the
    card's bf16 tolerance of the fp32 plain version."""
    shape = _shape(name)
    MB = -(-(int(INDEX.max()) + shape.span) // BS)
    q, k, v, table = _pool(H + D + BS, 3, shape.span, H, Kv, BS, MB, D=D)
    tree_args = (shape.depths, shape.bits)
    want = attn_tree(*_t(q, k, v, table, INDEX, *tree_args), window=window)
    got = paged_split_ref(*_t(q, k, v, table, INDEX), depths=shape.depths,
                          bits=shape.bits, window=window, chunk=8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    args = _j(q, k, v, table, INDEX, *tree_args)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_attn_tree(*args, window=window)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_tree_kernel(*args, window=window,
                                                interpret=True)), **TOL)
    bf = _bf16_pool(H + D, 3, shape.span, H, Kv, D, BS=BS, MB=MB)
    d, b = torch.from_numpy(shape.depths), torch.from_numpy(shape.bits)
    idx = torch.from_numpy(INDEX)
    torch.testing.assert_close(
        paged_split_ref(*bf, idx, depths=d, bits=b, window=window, p_bf16=True),
        attn_tree(*bf, idx, d, b, window=window), **CARD_BF16_TOL)
    chain = tree.chain_tree(1, 4)
    q1 = torch.from_numpy(q[:, :chain.span].copy())
    causal = paged_split_ref(q1, *_t(k, v, table, INDEX))
    width1 = paged_split_ref(q1, *_t(k, v, table, INDEX), depths=chain.depths,
                             bits=chain.bits)
    assert torch.equal(causal, width1)


@pytest.mark.parametrize("Q,H,D,tiles", [(1, 8, 48, 1), (5, 8, 48, 1),
                                         (1, 4, 32, 1), (5, 4, 48, 1),
                                         (64, 8, 48, 8), (9, 8, 48, 2)])
def test_plan_at_head_dims_32_and_48(Q, H, D, tiles):
    """B = 4, 4 / 2 kv-heads (GQA 2), block size 16 over 4 blocks a row
    (the pair's 64-token rows): one 64-key chunk, row tiles of 16 over
    Q * 2 rows, a workspace of D + 2 floats a (row, chunk); fp32 one walk."""
    Kv = H // 2
    p = pa.plan(torch.bfloat16, 4, Q, H, Kv, D, 16, 4)
    assert (p.row_tile, p.row_tiles, p.chunks) == (16, tiles, 1)
    assert p.workspace == 4 * Kv * Q * 2 * 1 * (D + 2)
    f = pa.plan(torch.float32, 4, Q, H, Kv, D, 16, 4)
    assert (f.row_tiles, f.chunks, f.workspace) == (tiles, 1, 0)
