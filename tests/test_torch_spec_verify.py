"""Port parity: greedy verification. The port's ``verify_greedy`` and its
fused form (whose argmax a CPU tensor takes as the plain version) against
the JAX package's ``acceptance.verify_greedy`` and the Pallas
``verify_greedy_fused`` in interpret mode, on the same seeded numpy
logits — EXACT equality of n_accepted, out_tokens and n_emitted,
including planted ties within and across the Pallas kernel's 2048-wide
vocab blocks (the first maximum wins everywhere)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import acceptance as jax_acceptance  # noqa: E402
from repro.kernels.spec_verify import verify_greedy_fused as jax_fused  # noqa: E402
from repro_torch.core import acceptance  # noqa: E402
from repro_torch.kernels import spec_verify  # noqa: E402


def _case(B, G, V, scenario, seed=0):
    rng = np.random.default_rng(seed + 31 * B + 7 * G + V)
    logits = rng.standard_normal((B, G + 1, V)).astype(np.float32)
    if scenario == "ties":
        top = np.float32(logits.max() + 1.0)
        for b in range(B):
            for g in range(G + 1):
                lo = int(rng.integers(0, min(V, 2048) - 8))
                # within one 2048-block: two equal maxima 5 apart
                logits[b, g, lo] = top
                logits[b, g, lo + 5] = top
                if V > 2048:
                    # across blocks: the same maximum again in block 1
                    logits[b, g, 2048 + int(rng.integers(0, V - 2048))] = top
    tgt = logits.argmax(-1)
    if scenario == "full_accept":
        drafts = tgt[:, :G].copy()
    elif scenario == "zero_accept":
        drafts = (tgt[:, :G] + 1) % V
    else:
        # a mix: row b matches the first b % (G+1) positions, then misses
        drafts = (tgt[:, :G] + 1) % V
        for b in range(B):
            n = b % (G + 1)
            drafts[b, :n] = tgt[b, :n]
    return drafts.astype(np.int32), logits


def _assert_same(port_res, jax_res):
    for name in ("n_accepted", "out_tokens", "n_emitted"):
        np.testing.assert_array_equal(getattr(port_res, name).numpy(),
                                      np.asarray(getattr(jax_res, name)),
                                      err_msg=name)


@pytest.mark.parametrize("scenario", ["mixed", "ties", "full_accept",
                                      "zero_accept"])
@pytest.mark.parametrize("V", [512, 3000])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("B", [1, 3])
def test_verify_matches_jax_exactly(B, G, V, scenario):
    drafts, logits = _case(B, G, V, scenario)
    d_t, l_t = torch.from_numpy(drafts), torch.from_numpy(logits)
    port = acceptance.verify_greedy(d_t, l_t)
    fused = spec_verify.verify_greedy_fused(d_t, l_t)
    want = jax_acceptance.verify_greedy(jnp.asarray(drafts), jnp.asarray(logits))
    want_kernel = jax_fused(jnp.asarray(drafts), jnp.asarray(logits),
                            interpret=True)
    _assert_same(port, want)
    _assert_same(fused, want)
    _assert_same(port, want_kernel)
    if scenario == "full_accept":
        assert (port.n_accepted.numpy() == G).all()
    if scenario == "zero_accept":
        assert (port.n_accepted.numpy() == 0).all()


@pytest.mark.parametrize("scenario", ["mixed", "ties"])
def test_round_verify_goes_through_the_wrapper_without_launching(scenario):
    """The round core's greedy verify calls the kernel wrapper, which takes
    the plain version for a CPU tensor."""
    from repro_torch.core import rounds
    drafts, logits = _case(3, 4, 3000, scenario)
    before = spec_verify.blockwise_argmax.launches
    got = rounds._greedy_verify(torch.from_numpy(drafts), torch.from_numpy(logits))
    assert spec_verify.blockwise_argmax.launches == before == 0
    _assert_same(got, jax_acceptance.verify_greedy(jnp.asarray(drafts),
                                                   jnp.asarray(logits)))


def test_argmax_ties_take_the_first_maximum_without_launching():
    logits = np.zeros((4, 5000), np.float32)
    logits[0, [3, 4000]] = 2.0          # across blocks
    logits[1, [2047, 2048]] = 1.0       # straddling a block edge
    logits[2, [10, 11, 12]] = 7.0       # within a block
    logits[3] = -np.inf                 # nothing finite: index 0
    before = spec_verify.blockwise_argmax.launches
    got = spec_verify.blockwise_argmax(torch.from_numpy(logits)).numpy()[:, 0]
    assert spec_verify.blockwise_argmax.launches == before == 0
    np.testing.assert_array_equal(got, [3, 2047, 10, 0])
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnp.asarray(logits),
                                                             axis=-1)))
