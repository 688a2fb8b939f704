"""Port parity for the tree slice's numpy-only topology and its attention:
``repro_torch.core.tree`` against ``repro.core.tree`` (shapes, masks and
validation errors), and the port's tree-verify attention (plain PyTorch
version, the path a CPU tensor takes) against the JAX package's jnp
oracle ``attn_tree`` and its Pallas kernel ``tree_flash_attention`` in
interpret mode, on the same seeded numpy inputs. fp32 throughout;
tolerance atol=rtol=1e-5 (the two frameworks sum the scores and the
weighted values in different orders). The CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import tree as jax_tree  # noqa: E402
from repro.kernels.tree_attention import tree_flash_attention as jax_kernel  # noqa: E402
from repro.models.attention import attn_tree as jax_attn_tree  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels.tree_attention import fold_window  # noqa: E402
from repro_torch.models.attention import (attention_tree, attn_paged,  # noqa: E402
                                          attn_tree)

TOL = dict(atol=1e-5, rtol=1e-5)
# irregular: root -> {1, 2}; 1 -> {3, 4}; 2 -> {5}; 4 -> {6}
IRREGULAR = (0, 0, 1, 1, 2, 4)
SHAPES = {"chain2x4": lambda m: m.chain_tree(2, 4),       # the main path's
          "chain5x6": lambda m: m.chain_tree(5, 6),       # span 31: bit 30
          "chain1x3": lambda m: m.chain_tree(1, 3),       # degenerate linear
          "irregular": lambda m: m.TreeShape(parents=IRREGULAR)}


# ------------------------------------------------------------- core/tree.py
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tree_shape_matches_jax(name):
    got, want = SHAPES[name](tree), SHAPES[name](jax_tree)
    assert got.span == want.span and got.n_nodes == want.n_nodes
    np.testing.assert_array_equal(got.depths, want.depths)
    np.testing.assert_array_equal(got.bits, want.bits)
    assert got.bits.dtype == want.bits.dtype == np.int32
    assert got.leaves == want.leaves and got.paths == want.paths
    assert got.max_depth == want.max_depth
    if hasattr(want, "chain_slots"):
        np.testing.assert_array_equal(got.chain_slots, want.chain_slots)


@pytest.mark.parametrize("span", [1, 2, 9, 31])
def test_linear_span_bits_match_jax(span):
    np.testing.assert_array_equal(tree.linear_span_bits(span),
                                  jax_tree.linear_span_bits(span))


@pytest.mark.parametrize("args,match", [
    (("chain", 5, 7), "span"),          # 36 > 31
    (("chain", 0, 3), "width"),
    (("chain", 2, 0), "width"),
    (("shape", (1,)), "parent"),        # forward parent
    (("shape", (0, 2)), "parent"),      # self parent
])
def test_tree_validation_errors_match_jax(args, match):
    for mod in (tree, jax_tree):
        with pytest.raises(ValueError, match=match):
            if args[0] == "chain":
                mod.chain_tree(args[1], args[2])
            else:
                mod.TreeShape(parents=args[1])
    assert tree.MAX_SPAN == jax_tree.MAX_SPAN == 31


# -------------------------------------------------------------- attention
def _case(seed, shape, B, H, Kv, BS, index, MB=None, D=16):
    """Seeded pools with one private block list per row; every row's tree
    span fits its table."""
    rng = np.random.default_rng(seed)
    span = shape.span
    MB = MB or -(-(max(index) + span) // BS)
    NB = B * MB + 2
    q = rng.standard_normal((B, span, H, D)).astype(np.float32)
    k = rng.standard_normal((NB, BS, Kv, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, Kv, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    return (q, k, v, table.astype(np.int32), np.asarray(index, np.int32),
            shape.depths, shape.bits)


def _port(fn, args, **kw):
    return fn(*[torch.from_numpy(np.asarray(a)) for a in args], **kw).numpy()


def _jax(fn, args, **kw):
    return np.asarray(fn(*[jnp.asarray(a) for a in args], **kw))


CASES = [(H, Kv, BS, name, None)                  # gq 1, 2, 4
         for H, Kv in ((4, 4), (4, 2), (8, 2)) for BS in (4, 16)
         for name in ("chain2x4", "irregular")] + [
        (8, 2, BS, name, 3) for BS in (4, 16) for name in ("chain2x4", "irregular")]


@pytest.mark.parametrize("H,Kv,BS,name,window", CASES)
def test_plain_matches_jax_oracle_and_kernel(H, Kv, BS, name, window):
    args = _case(BS * 100 + H * 10 + Kv, SHAPES[name](tree), 3, H, Kv, BS,
                 index=(5, 19, 0))
    got = _port(attn_tree, args, window=window)
    np.testing.assert_allclose(got, _jax(jax_attn_tree, args, window=window),
                               **TOL)
    kern = _jax(jax_kernel, args, window=window, interpret=True)
    np.testing.assert_allclose(got, kern, **TOL)


@pytest.mark.parametrize("max_live", [7, 21, 40])
def test_max_live_cap(max_live):
    """An explicit live bound truncates the block scan exactly as the
    oracle and the Pallas kernel do (including a cap below some rows'
    own index + span)."""
    args = _case(11, SHAPES["chain2x4"](tree), 3, 8, 2, 4,
                 index=(5, 19, 2), MB=8)
    got = _port(attn_tree, args, max_live=max_live)
    want = _jax(jax_attn_tree, args, max_live=max_live)
    np.testing.assert_allclose(got, want, **TOL)
    kern = _jax(jax_kernel, args, max_live=max_live, interpret=True)
    np.testing.assert_allclose(got, kern, **TOL)


def test_span_31_uses_bit_30():
    args = _case(13, SHAPES["chain5x6"](tree), 2, 4, 2, 16, index=(3, 40))
    got = _port(attn_tree, args)
    np.testing.assert_allclose(got, _jax(jax_attn_tree, args), **TOL)
    np.testing.assert_allclose(got, _jax(jax_kernel, args, interpret=True),
                               **TOL)


def test_sibling_branches_do_not_leak():
    """Scores differ between the tree mask and full causal attention over
    the same span: if siblings were visible the two would coincide. The
    root sees only the prefix either way."""
    args = _case(17, tree.chain_tree(3, 3), 1, 4, 2, 4, index=(6,))
    t = _port(attn_tree, args)
    causal = _port(attn_paged, args[:5])
    np.testing.assert_allclose(t[:, 0], causal[:, 0], **TOL)
    assert not np.allclose(t[:, 1:], causal[:, 1:], rtol=1e-3, atol=1e-3)


def test_width1_tree_is_plain_causal_attention():
    args = _case(19, tree.chain_tree(1, 4), 2, 4, 2, 4, index=(7, 12))
    np.testing.assert_allclose(_port(attn_tree, args),
                               _port(attn_paged, args[:5]), **TOL)


@pytest.mark.parametrize("window", [1, 2, 3, 9])
def test_window_fold_matches_the_tree_mask(window):
    """The kernel wrapper's window fold keeps exactly the in-span pairs
    ``_tree_mask`` keeps: slot t visible to s iff t is on s's root path
    and their depth gap is inside the window."""
    shape = tree.TreeShape(parents=IRREGULAR)
    d, b = torch.from_numpy(shape.depths), torch.from_numpy(shape.bits)
    got = fold_window(d, b, window).numpy()
    want = np.zeros(shape.span, np.int64)
    for s in range(shape.span):
        for t in range(shape.span):
            if (shape.bits[s] >> t) & 1 and shape.depths[s] - shape.depths[t] < window:
                want[s] |= 1 << t
    np.testing.assert_array_equal(got, want)


def test_cpu_call_takes_plain_version_without_launching():
    args = _case(3, SHAPES["irregular"](tree), 3, 4, 2, 8, index=(5, 11, 0))
    tensors = [torch.from_numpy(np.asarray(a)) for a in args]
    before = ta.tree_flash_attention.launches
    direct = ta.tree_flash_attention(*tensors, window=3).numpy()
    via_model = attention_tree(*tensors, window=3).numpy()
    assert ta.tree_flash_attention.launches == before == 0
    want = _port(attn_tree, args, window=3)
    np.testing.assert_array_equal(direct, want)
    np.testing.assert_array_equal(via_model, want)
