"""Port parity: the port's no-cache flash attention (the wrapper on CPU
tensors, which takes the plain version) against the JAX package's Pallas
kernel ``flash_attention`` in interpret mode (bq = bs = 8) and its jnp
oracle ``repro.kernels.ref.flash_attention_ref``, on the same seeded numpy
inputs; and the port's model-level ``attention`` against JAX's on both
sides of its dense/chunked rule (S <= 2*chunk).

Tolerances: fp32 atol = rtol = 1e-5 (the frameworks sum the scores and the
weighted values in different orders); bf16 atol = rtol = 1e-2 (both round
the fp32 result to bf16 once, and a sum-order difference can move it by one
bf16 step). The CUDA kernel itself is held against the same plain version
on the card by ``chip_smoke.py``; here its bf16 path's one departure from
the plain arithmetic (weights rounded to bf16 before the PV product) is
held to the card's bf16 tolerance, and its launch plan to covering every
query row once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_kernel  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
H100_SMS = 132   # streaming multiprocessors of an H100 SXM


def _inputs(seed, B, Sq, Skv, H, Kv, D, dtype):
    """Seeded numpy inputs, rounded to ``dtype`` once so both frameworks
    read the same numbers."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Sq, H, D), (B, Skv, Kv, D), (B, Skv, Kv, D))]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                for a in arrs]
    return arrs


def _port(q, k, v, dtype, **kw):
    t = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)]
    return fa.flash_attention(*t, **kw).float().numpy()


def _jax(fn, q, k, v, dtype, **kw):
    j = [jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v)]
    return np.asarray(fn(*j, **kw), np.float32)


@pytest.mark.parametrize("dtype,S", [("float32", 13), ("float32", 37),
                                     ("bfloat16", 13)])
@pytest.mark.parametrize("gq", [1, 2, 4])
@pytest.mark.parametrize("window,causal", [(None, True), (5, True),
                                           (None, False), (5, False)])
def test_plain_matches_jax_kernel_and_oracle(window, causal, gq, S, dtype):
    Kv = 2
    q, k, v = _inputs(S * 10 + gq, 2, S, S, Kv * gq, Kv, 16, dtype)
    got = _port(q, k, v, dtype, window=window, causal=causal)
    kern = _jax(jax_ops.flash_attention, q, k, v, dtype, bq=8, bs=8,
                window=window, causal=causal)
    want = _jax(jax_ref.flash_attention_ref, q, k, v, dtype, window=window,
                causal=causal)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("Sq,Skv,s_valid,window,causal", [
    (16, 24, 19, None, True), (16, 24, 19, 5, True), (16, 24, 19, 5, False),
    (16, 16, 11, None, True), (16, 16, 11, None, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s_valid_masks_the_kv_tail(Sq, Skv, s_valid, window, causal, dtype):
    """Keys at or past s_valid are invisible: the port equals JAX's kernel
    (which takes s_valid directly at block-multiple shapes) and the oracle
    on the truncated keys. Every row keeps a visible key."""
    q, k, v = _inputs(s_valid, 2, Sq, Skv, 4, 2, 16, dtype)
    got = _port(q, k, v, dtype, window=window, causal=causal, s_valid=s_valid)
    kern = _jax(jax_kernel, q, k, v, dtype, bq=8, bs=8, window=window,
                causal=causal, interpret=True, s_valid=s_valid)
    want = _jax(jax_ref.flash_attention_ref, q, k[:, :s_valid],
                v[:, :s_valid], dtype, window=window, causal=causal)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("S", [13, 37])           # chunk 8: dense, chunked
@pytest.mark.parametrize("window,causal", [(None, True), (5, True),
                                           (None, False)])
def test_attention_matches_jax_on_both_paths(S, window, causal):
    q, k, v = _inputs(S, 2, S, S, 4, 2, 16, "float32")
    pos = np.arange(S, dtype=np.int32)
    got = attention.attention(
        *[torch.from_numpy(a) for a in (q, k, v)], torch.from_numpy(pos),
        torch.from_numpy(pos), window=window, chunk=8, causal=causal).numpy()
    want = np.asarray(jax_attention.attention(
        *[jnp.asarray(a) for a in (q, k, v, pos, pos)], window=window,
        chunk=8, causal=causal))
    np.testing.assert_allclose(got, want, **TOL["float32"])
    chunked = attention.attn_chunked(
        *[torch.from_numpy(a) for a in (q, k, v)], torch.from_numpy(pos),
        torch.from_numpy(pos), window=window, chunk=8, causal=causal).numpy()
    np.testing.assert_allclose(chunked, want, **TOL["float32"])


def test_cpu_call_takes_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 2, 13, 13, 4, 2, 16,
                                                     "float32"))
    before = fa.flash_attention.launches
    direct = fa.flash_attention(q, k, v, window=5).numpy()
    via_ops = ops.flash_attention(q, k, v, window=5).numpy()
    via_model = attention.attention_flash(q, k, v, window=5).numpy()
    assert fa.flash_attention.launches == before == 0
    want = fa.plain(q, k, v, window=5).numpy()
    np.testing.assert_array_equal(direct, want)
    np.testing.assert_array_equal(via_ops, want)
    np.testing.assert_allclose(via_model, want, **TOL["float32"])


@pytest.mark.parametrize("s_valid", [0, 14])
def test_s_valid_out_of_range_raises(s_valid):
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 13, 13, 4, 2, 16,
                                                     "float32"))
    with pytest.raises(ValueError, match="s_valid"):
        fa.flash_attention(q, k, v, s_valid=s_valid)


# ------------------------------------------------- the bf16 kernel's rounding
CARD_BF16_TOL = dict(atol=1e-2, rtol=1e-2)   # chip_smoke.py's bf16 tolerance


def _bf16_weights_attention(q, k, v):
    """Causal attention as the bf16 kernel rounds it, in fp32: scores and
    the softmax denominator in fp32, the weights P rounded to bf16 before
    the PV product (their role as the A operand of a bf16 tensor-core
    product)."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    qf = q.reshape(B, S, Kv, H // Kv, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k) * D ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(torch.bfloat16).float(), v)
    o = pv / torch.clamp(den, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


@pytest.mark.parametrize("S", [134, 2048])
@pytest.mark.parametrize("D", [32, 48, 64, 128, 256])
def test_bf16_weights_stay_within_the_card_tolerance(S, D):
    """Rounding P to bf16 (the kernel's PV operand) keeps the output within
    chip_smoke.py's bf16 tolerance of the fp32 plain version, at the main
    path's length and the longest case's, for every head width."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(S + D, 1, S, S, 4, 2, D,
                                                     "bfloat16"))
    got = _bf16_weights_attention(q, k, v)
    want = fa.plain(q, k, v)
    torch.testing.assert_close(got, want, **CARD_BF16_TOL)


def test_plan_covers_every_query_row_once():
    """Over ragged shapes: the row tiles cover the Sq * gq rows of each
    (kv-head, batch row) exactly once, with the tile sizes the kernel
    instantiates; 128-row tiles only for D = 128, no window, and a grid
    that still gives every SM of the card two blocks."""
    hyp = pytest.importorskip("hypothesis")   # requirements-test.txt
    st = hyp.strategies

    @hyp.settings(max_examples=200, deadline=None)
    @hyp.given(dtype=st.sampled_from([torch.float32, torch.bfloat16]),
               B=st.integers(1, 8), Sq=st.integers(1, 4096),
               Kv=st.integers(1, 16), gq=st.integers(1, 8),
               D=st.sampled_from([32, 48, 64, 128, 256]),
               window=st.sampled_from([None, 8, 100]),
               sms=st.sampled_from([H100_SMS, 114, 16]))
    def check(dtype, B, Sq, Kv, gq, D, window, sms):
        _check_flash_plan(dtype, B, Sq, Kv, gq, D, window, sms)

    check()


def _check_flash_plan(dtype, B, Sq, Kv, gq, D, window, sms):
    allowed = fa.BF16_ROWS if dtype == torch.bfloat16 else (fa.F32_ROWS,)
    p = fa.plan(dtype, B, Sq, Kv * gq, Kv, D, window, sms=sms)
    assert p.row_tile in allowed
    n_rows = Sq * gq
    if dtype == torch.bfloat16:
        long_walks = -(-n_rows // 128) * Kv * B >= 2 * sms
        assert (p.row_tile == 128) == (D == 128 and window is None and long_walks)
    owner = np.zeros(n_rows, dtype=np.int64)
    for tile in range(p.row_tiles):
        lo = tile * p.row_tile
        assert lo < n_rows                       # no tile without rows
        owner[lo:lo + p.row_tile] += 1
    assert (owner == 1).all()


@pytest.mark.parametrize("S,D,rows", [(134, 128, 64), (134, 64, 64),
                                      (2048, 128, 128), (2048, 64, 64),
                                      (1100, 128, 128)])
def test_plan_picks_the_measured_tile_at_the_chip_smoke_shapes(S, D, rows):
    """B=2, 8 kv-heads, the 3B (gq 3) and 1B (gq 4) geometries: 64-row
    tiles on the main path (S = 134), 128-row tiles for the 3B geometry's
    long causal walks."""
    H = 24 if D == 128 else 32
    assert fa.plan(torch.bfloat16, 2, S, H, 8, D, sms=H100_SMS).row_tile == rows


@pytest.mark.parametrize("sms,rows", [(H100_SMS, 128), (114, 128), (512, 64)])
def test_plan_sizes_the_tile_by_the_cards_sm_count(sms, rows):
    """The 3B geometry at S = 1100 (B=2, 8 kv-heads) has 26 128-row tiles
    per (kv-head, batch row), 416 blocks: at least two per SM of an H100
    SXM (132 SMs) or PCIe (114), but not of a card with 512 SMs, which
    keeps 64-row tiles."""
    assert fa.plan(torch.bfloat16, 2, 1100, 24, 8, 128, sms=sms).row_tile == rows


# ------------------------------------------------------------ head_dim 256
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,causal", [(None, True), (5, True),
                                           (None, False)])
@pytest.mark.parametrize("H", [10, 4])      # recurrentgemma-2b, -draft (Kv 1)
def test_plain_matches_jax_kernel_and_oracle_at_head_dim_256(H, window, causal,
                                                             dtype):
    """RecurrentGemma's MQA heads at D = 256, the hybrid family's no-cache
    attention: the plain version against the interpret-mode Pallas kernel
    and the jnp oracle, as at the other head dims."""
    q, k, v = _inputs(H * 7 + (window or 0), 2, 13, 13, H, 1, 256, dtype)
    got = _port(q, k, v, dtype, window=window, causal=causal)
    kern = _jax(jax_ops.flash_attention, q, k, v, dtype, bq=8, bs=8,
                window=window, causal=causal)
    want = _jax(jax_ref.flash_attention_ref, q, k, v, dtype, window=window,
                causal=causal)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("S,window", [(134, None), (2048, None), (1100, 64)])
@pytest.mark.parametrize("H", [10, 4])
def test_plan_keeps_64_row_tiles_at_head_dim_256(H, S, window):
    """D = 256 runs the 64-row bf16 block (the kernel's only instantiation
    there) at chip_smoke.py's hybrid shapes, B = 2, one kv-head; fp32 its
    16-row block."""
    p = fa.plan(torch.bfloat16, 2, S, H, 1, 256, window, sms=H100_SMS)
    assert (p.row_tile, p.row_tiles) == (64, -(-S * H // 64))
    assert fa.plan(torch.float32, 2, S, H, 1, 256, window,
                   sms=H100_SMS).row_tile == fa.F32_ROWS


# ----------------------------------------------------- head dims 32 and 48
# the bench pair of benchmarks/common.py: its target 8 / 4 heads of 48; its
# drafter 4 / 2 heads of 48 (``replace`` keeps the target's derived
# head_dim); d 128 over 4 / 2 at d / H = 32
PAIR_GEOMS = [(8, 4, 48), (4, 2, 48), (4, 2, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,causal", [(None, True), (5, True),
                                           (None, False)])
@pytest.mark.parametrize("H,Kv,D", PAIR_GEOMS)
def test_plain_matches_jax_kernel_and_oracle_at_head_dims_32_and_48(
        H, Kv, D, window, causal, dtype):
    """The pair's no-cache attention at D 48 (and D 32): the plain version
    against the interpret-mode Pallas kernel and the jnp oracle on 21
    ragged positions (three 8-row blocks, the last partial)."""
    q, k, v = _inputs(H * 11 + D + (window or 0), 2, 21, 21, H, Kv, D, dtype)
    got = _port(q, k, v, dtype, window=window, causal=causal)
    kern = _jax(jax_ops.flash_attention, q, k, v, dtype, bq=8, bs=8,
                window=window, causal=causal)
    want = _jax(jax_ref.flash_attention_ref, q, k, v, dtype, window=window,
                causal=causal)
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("S", [48, 134, 2048])
@pytest.mark.parametrize("H,Kv,D", PAIR_GEOMS)
def test_plan_takes_64_row_tiles_at_head_dims_32_and_48(H, Kv, D, S):
    """D 32 and 48 run the 64-row bf16 block (128-row tiles are for
    D = 128 only) and the 16-row fp32 block, at the pair's training length
    (48), a no-cache buffer (134) and a long walk, B = 16."""
    p = fa.plan(torch.bfloat16, 16, S, H, Kv, D, sms=H100_SMS)
    assert (p.row_tile, p.row_tiles) == (64, -(-S * (H // Kv) // 64))
    assert fa.plan(torch.float32, 16, S, H, Kv, D,
                   sms=H100_SMS).row_tile == fa.F32_ROWS
