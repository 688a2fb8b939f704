"""The split computation of the SSD scan kernel and the launch plans of the
SSD scan and the greedy-verify argmax, on the CPU.

``ref.ssd_split_ref`` is the SSD kernel's decomposition in plain PyTorch:
y items (the causal score tile of one 16-row tile, shared by a head group,
each head's decay, the product with X), state items (each chunk's
contribution to the next state) and the carry (the state walked over the
chunks in order, its product with C added to y_diag). It is held against
the JAX package's Pallas kernel in interpret mode and its jnp oracle, on
the same seeded numpy inputs, fp32, to atol=rtol=1e-5, with the group
broadcast of B and C as a stride-0 view and as a copy, and with head groups
forced on; its rows below k·chunk must be bit-equal between l = k·chunk and
l = k·chunk + 6 (the no-cache engine's AR and spec buffers). The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``, which also checks the bit-equality there
(``ssd_l_invariance``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import spec_verify as sv  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ref import ssd_split_ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, b, l, h, p, n):
    """x, dA (negative log-decays), and B, C as one group over the heads."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dA = -rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32)
    Bm = (rng.standard_normal((b, l, 1, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, l, 1, n)) * 0.5).astype(np.float32)
    return x, dA, Bm, Cm


def _views(arrs, h):
    """torch inputs with B and C broadcast to the heads by a stride-0 view."""
    x, dA, Bm, Cm = (torch.from_numpy(a) for a in arrs)
    b, l, _, n = Bm.shape
    return x, dA, Bm.expand(b, l, h, n), Cm.expand(b, l, h, n)


SHAPES = [
    (1, 16, 2, 8, 4, 4), (2, 32, 4, 16, 8, 8),    # l a multiple of chunk
    (2, 20, 8, 32, 16, 8),                        # the mamba2-780m smoke shape
    (1, 13, 2, 8, 4, 4), (2, 27, 4, 16, 8, 8),    # ragged
    (1, 40, 4, 8, 16, 32),                        # 32-row chunks: two row tiles
    (2, 21, 4, 10, 6, 8),                         # p and n not multiples of 4
]


@pytest.mark.parametrize("heads", ["planned", "forced"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES)
def test_split_matches_the_pallas_kernel_and_oracle(b, l, h, p, n, chunk, heads):
    arrs = _inputs(b * 100 + l + h, b, l, h, p, n)
    x, dA, Bv, Cv = _views(arrs, h)
    # "forced": a 2-SM card makes the plan group every head it can
    sms = 132 if heads == "planned" else 2
    plan = ss.plan(b, l, h, p, n, chunk, sms, shared=True)
    if heads == "forced":
        assert plan.heads == max(g for g in ss.HEAD_GROUPS if h % g == 0)
    view = ssd_split_ref(x, dA, Bv, Cv, chunk=chunk, plan=plan).numpy()
    copy = ssd_split_ref(x, dA, Bv.contiguous(), Cv.contiguous(), chunk=chunk,
                         plan=ss.plan(b, l, h, p, n, chunk, sms, shared=False)).numpy()
    j = [jnp.asarray(a) for a in (arrs[0], arrs[1],
                                  np.broadcast_to(arrs[2], (b, l, h, n)),
                                  np.broadcast_to(arrs[3], (b, l, h, n)))]
    kern = np.asarray(jax_ops.ssd_scan(*j, chunk=chunk))
    want = np.asarray(jax_ref.ssd_scan_ref(*j, chunk=chunk))
    for got in (view, copy):
        assert got.shape == (b, l, h, p) and got.dtype == np.float32
        np.testing.assert_allclose(got, kern, **TOL)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("b,h,p,n,chunk,k", [
    (2, 4, 8, 16, 8, 3), (1, 4, 16, 8, 16, 2), (2, 2, 8, 4, 32, 1)])
def test_rows_below_k_chunks_are_bit_equal_across_l(b, h, p, n, chunk, k, sms):
    """Rows 0..k·chunk-1 at l = k·chunk and at l = k·chunk + 6 (the AR
    buffer T=128 against the spec buffer T=134 on the main path)."""
    L = k * chunk
    arrs = _inputs(L + chunk, b, L + 6, h, p, n)
    x, dA, Bv, Cv = _views(arrs, h)
    long = ssd_split_ref(x, dA, Bv, Cv, chunk=chunk,
                         plan=ss.plan(b, L + 6, h, p, n, chunk, sms))
    short = ssd_split_ref(x[:, :L], dA[:, :L], Bv[:, :L], Cv[:, :L], chunk=chunk,
                          plan=ss.plan(b, L, h, p, n, chunk, sms))
    assert torch.equal(long[:, :L], short)


def _coverage(b, l, h, p, n, chunk, sms, shared):
    plan = ss.plan(b, l, h, p, n, chunk, sms, shared=shared)
    items = ss.y_items(plan, b, h, chunk)
    assert len(items) == plan.y_blocks
    assert h % plan.heads == 0 and (shared or plan.heads == 1)
    written = np.zeros((b, l, h), np.int64)
    for bb, h0, c, t in items:
        nv = min(chunk, l - c * chunk)
        assert h0 % plan.heads == 0
        r0 = t * ss.ROW_TILE
        assert 0 <= r0 < nv
        rows = slice(c * chunk + r0, c * chunk + min(nv, r0 + ss.ROW_TILE))
        written[bb, rows, h0:h0 + plan.heads] += 1
    assert (written == 1).all()
    # each needed chunk state (every chunk with a successor) is made once,
    # column tile by column tile
    made = np.zeros((b, h, max(plan.chunks - 1, 0), n), np.int64)
    st_items = ss.state_items(plan, b, h, n)
    assert len(st_items) == plan.state_blocks
    for bb, hd, c, k0 in st_items:
        made[bb, hd, c, k0:k0 + ss.K_TILE] += 1
    assert (made == 1).all()
    assert plan.workspace == made.size * -(-p // 4) * 4
    # the carry blocks hold every row after chunk 0
    tiles = -(-(chunk if plan.chunks >= 3 else plan.last_rows) // ss.CARRY_ROWS)
    assert plan.carry_blocks == (b * h * tiles if plan.chunks > 1 else 0)
    assert tiles * ss.CARRY_ROWS >= min(chunk, l - chunk) or plan.chunks == 1
    return plan


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 3), l=st.integers(1, 420),
       h=st.sampled_from([1, 2, 3, 4, 6, 8, 12, 24, 48]),
       p=st.integers(1, 64), n=st.integers(1, 128), chunk=st.integers(1, 128),
       sms=st.sampled_from([1, 8, 66, 114, 132]), shared=st.booleans())
def test_plan_writes_every_row_once_and_makes_each_state_once(
        b, l, h, p, n, chunk, sms, shared):
    _coverage(b, l, h, p, n, chunk, sms, shared)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 3), k=st.integers(1, 4), extra=st.integers(0, 300),
       h=st.sampled_from([1, 2, 4, 6, 24, 48]), chunk=st.integers(1, 128),
       sms=st.sampled_from([1, 66, 132]), shared=st.booleans())
def test_plan_tiles_rows_below_k_chunks_alike_for_every_longer_l(
        b, k, extra, h, chunk, sms, shared):
    L = k * chunk
    short = ss.plan(b, L, h, 64, 128, chunk, sms, shared=shared)
    long = ss.plan(b, L + extra, h, 64, 128, chunk, sms, shared=shared)
    assert short.heads == long.heads

    def below(plan, l):
        return sorted(it for it in ss.y_items(plan, b, h, chunk) if it[2] < k)
    assert below(short, L) == below(long, L + extra)


def test_plan_reads_only_the_sm_count(monkeypatch):
    """The plan asks the card nothing: with every CUDA query failing it
    still plans, and only ``sms`` changes its head groups."""
    def boom(*a, **k):
        raise AssertionError("the plan queried the card")
    for name in ("is_available", "get_device_properties", "current_device",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, boom)
    target = ss.plan(2, 134, 48, 64, 128, 128, 132)
    drafter = ss.plan(2, 134, 24, 64, 128, 128, 132)
    assert target == ss.SsdPlan(4, 16, 2, 6, 2 * 12 * 9, 192, 96, 2 * 48 * 64 * 128)
    assert drafter.heads == 4 and drafter.y_blocks == 2 * 6 * 9
    assert ss.plan(2, 134, 48, 64, 128, 128, 8).heads == 4
    assert ss.plan(2, 134, 48, 64, 128, 128, 400).heads == 2
    assert ss.plan(2, 134, 48, 64, 128, 128, 2000).heads == 1
    assert ss.plan(2, 134, 48, 64, 128, 128, 132, shared=False).heads == 1


def test_main_path_plans_fill_the_card():
    """At the main path's shapes the chunk kernel has more blocks than the
    H100 has SMs, for the target and the drafter."""
    for h in (48, 24):
        plan = _coverage(2, 134, h, 64, 128, 128, 132, True)
        assert plan.y_blocks + plan.state_blocks >= 132


@pytest.mark.parametrize("V,cluster", [(128256, 8), (50280, 8), (512, 1)])
def test_argmax_plan_gives_each_row_one_cluster(V, cluster):
    """The argmax's cluster per row at the vocabularies of Llama 3, Mamba-2
    and the smoke configs: at most MAX_CLUSTER blocks, each with at least
    PER_BLOCK logits when there are several. The kernel's split of a row over
    its cluster is held on the card (chip_smoke.py's argmax case, rows at
    every alignment)."""
    plan = sv.plan(20, V)
    assert plan == sv.ArgmaxPlan(cluster, 20 * cluster)
    assert plan.cluster <= sv.MAX_CLUSTER
    assert plan.cluster == 1 or V // plan.cluster >= sv.PER_BLOCK
