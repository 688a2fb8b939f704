"""Cached w8a8 parity against ``repro``: the cached ``SpecEngine`` on
``quantize_for_serving`` weights under ``act_quant`` with a static scale,
for the dense ``llama3.2-3b`` smoke pair and the ``llama4-smoke`` MoE pair
(``_serving_parity.build_pair`` and ``moe_pair``), fp32, tokens exactly.
The MoE case holds the family's split: the router and the shared expert go
through ``layers.linear`` (the int8 path's plain version here), the routed
experts dequantize and are not act-quantized, as in JAX
(tests/test_torch_moe.py checks the split call by call)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _serving_parity import build_pair, moe_pair, one_torch_thread  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.quant import int8 as jq8  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.quant import int8 as q8  # noqa: E402

GAMMA = 4
STATS = ("rounds", "accepted", "drafted", "tokens_generated")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("which", ["dense", "llama4"])
def test_cached_w8a8_spec_engine_matches_jax(which):
    """``quantize_for_serving`` weights under ``act_quant`` (static scale):
    the port's int8 path (plain version on the CPU) in every
    ``layers.linear``, the MoE router and shared expert included, the
    routed experts dequantized; JAX fake-quantizes on dequantized weights.
    The target drafts for itself, so rounds accept most drafts and reject
    some (the cached drafter's hole). Tokens, rounds and acceptance JAX's,
    tokens cached AR's."""
    pair = (build_pair() if which == "dense"
            else moe_pair("llama4-maverick-400b-a17b", blocks=2))
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    jpt, pt = jq8.quantize_for_serving(jpt), q8.quantize_for_serving(pt)
    prompt = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)
    jeng = jax_engine.SpecEngine(jt, jt, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy="modular"))
    eng = engine.SpecEngine(mt, mt, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    with jq8.act_quant(static_scale=0.05), q8.act_quant(static_scale=0.05):
        want, jst = jeng.generate(jpt, jpt, jnp.asarray(prompt), 12)
        toks, stats = eng.generate(pt, pt, prompt, 12)
        ar = engine.autoregressive_generate(mt, pt, prompt, 12, use_cache=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    for k in STATS:
        assert stats[k] == int(jst[k]), k
    np.testing.assert_array_equal(toks[:, :9 + 12].numpy(), ar.numpy())
    assert 0 < stats["accepted"] < stats["drafted"]
