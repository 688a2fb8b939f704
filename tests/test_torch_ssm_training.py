"""Mamba-2 training in the port against ``repro`` on the CPU. The SSD kernel
has no backward pass, so under grad the model's no-cache scan runs
``models.ssm.ssd_chunked`` (the function JAX's model trains through), and
everywhere else ``kernels.ops.ssd_scan``: the choice is the model's, by
grad mode, as the flash wrapper's autograd function is; the kernel's
wrapper still refuses grad (``test_torch_training.py``).

Held here: which function runs in each mode (counted by monkeypatching
both); a model on meta tensors under grad never reaches the kernel's
refusal; the ``mamba2-780m`` smoke config's loss and every gradient leaf
against ``jax.value_and_grad`` of JAX's ``loss_fn`` on sequences that cross
the 8-token chunk boundary, one ragged; three AdamW steps against JAX's
jitted step. Tolerances as ``test_torch_train_loop.py``'s: losses fp32
rtol 1e-5, gradients |d| <= 1e-4 * max|g| + 1e-6 per leaf (XLA and
PyTorch sum the chunked scan in other orders), params after each step
|d| <= 1e-5 * max|p| + 1e-6 with AdamW's eps at 1e-4 (see that file)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train_loop as jax_tl  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

ARCH = "mamba2-780m"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config (2 layers, chunk 8) in both frameworks, the port's
    params bridged from JAX's init."""
    jcfg, cfg = jax_registry.smoke_config(ARCH), registry.smoke_config(ARCH)
    assert cfg.ssm_chunk == 8
    jm, m = jax_build(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, m, jp, params_from_numpy(cfg, _to_np(jp), "cpu")


def _batch(cfg, seed, b, s):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _counting(monkeypatch):
    """Count calls of the kernel wrapper and of ``ssd_chunked`` as
    ``ssm_mix`` reaches them (the plain SSD version binds its own
    ``ssd_chunked``, so a kernel-path call is not counted twice)."""
    calls = {"ssd_scan": 0, "ssd_chunked": 0}
    real_scan, real_chunked = ops.ssd_scan, ssm.ssd_chunked

    def scan(*a, **k):
        calls["ssd_scan"] += 1
        return real_scan(*a, **k)

    def chunked(*a, **k):
        calls["ssd_chunked"] += 1
        return real_chunked(*a, **k)
    monkeypatch.setattr(ops, "ssd_scan", scan)
    monkeypatch.setattr(ssm, "ssd_chunked", chunked)
    return calls


def test_the_scan_is_chosen_by_grad_mode(smoke, monkeypatch):
    """Under grad with params that require it (a train step's
    ``value_and_grad``) every layer runs ``ssd_chunked`` and the kernel
    wrapper never; under ``no_grad``, and in grad mode on params that
    require no grad, every layer runs the kernel wrapper."""
    _, m, _, tp = smoke
    L = m.cfg.num_layers
    toks, labels = (torch.as_tensor(a) for a in _batch(m.cfg, 1, 2, 20))
    calls = _counting(monkeypatch)
    train_loop.value_and_grad(m, tp, toks, labels)
    assert calls == {"ssd_scan": 0, "ssd_chunked": L}
    for k in calls:
        calls[k] = 0
    with torch.no_grad():
        m.apply(tp, toks)
    assert calls == {"ssd_scan": L, "ssd_chunked": 0}
    calls["ssd_scan"] = 0
    m.apply(tp, toks)
    assert calls == {"ssd_scan": L, "ssd_chunked": 0}


def test_a_device_tensor_under_grad_never_reaches_the_kernel():
    """One mixer layer on meta tensors (the wrappers take the kernel
    branch for any non-CPU tensor) with a param requiring grad: the
    forward runs ``ssd_chunked``, where the kernel's wrapper would raise
    ("no backward"); under ``no_grad`` the wrapper is reached and refuses
    the meta device."""
    cfg = registry.smoke_config(ARCH)
    p = ssm.init_layer(torch.Generator().manual_seed(0), cfg, "meta")
    p["in_proj"]["w"].requires_grad_(True)
    x = torch.empty((2, 20, cfg.d_model), device="meta")
    out, _ = ssm.ssm_mix(cfg, p, x)
    assert out.shape == x.shape and out.requires_grad
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        ssm.ssm_mix(cfg, p, x)


@pytest.mark.parametrize("S", [16, 20, 29])
def test_smoke_loss_and_grads_match_jax_across_chunks(smoke, S):
    """Two, three and four 8-token chunks (20 and 29 end in a ragged
    chunk, padded inside ``ssd_chunked``): the loss and each gradient leaf
    against ``jax.value_and_grad`` of JAX's ``loss_fn``."""
    jm, m, jp, tp = smoke
    toks, labels = _batch(m.cfg, S, 2, S)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_tl.loss_fn(jm, p, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True))(jp)
    loss, _, grads = train_loop.value_and_grad(m, tp, torch.as_tensor(toks),
                                               torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = params_from_numpy(m.cfg, _to_np(jg), "cpu")
    for path, y in opt.leaves(want):
        x = opt.get(grads, path)
        err = float((x - y).abs().max())
        assert err <= 1e-4 * float(y.abs().max()) + 1e-6, (path, err)


def test_train_steps_match_jax(smoke):
    """Three AdamW steps (warmup 2, so the third is on the cosine) of the
    port's ``make_train_step`` against JAX's jitted step on 2 x 20 tokens:
    the losses and the params after each step."""
    jm, m, jp, tp = smoke
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=3, eps=1e-4)
    jstep = jax.jit(jax_tl.make_train_step(jm, jax_opt.AdamWConfig(**ocfg)))
    step = train_loop.make_train_step(m, opt.AdamWConfig(**ocfg))
    js = jax_opt.init(jp)
    ts = train_loop.init_opt_state(m, opt.AdamWConfig(**ocfg), tp)
    for i in range(3):
        toks, labels = _batch(m.cfg, 40 + i, 2, 20)
        jp, js, jmet = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels)})
        tp, ts, met = step(tp, ts, {"tokens": torch.as_tensor(toks),
                                    "labels": torch.as_tensor(labels)})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        want = params_from_numpy(m.cfg, _to_np(jp), "cpu")
        for path, y in opt.leaves(want):
            x = opt.get(tp, path).float()
            err = float((x - y.float()).abs().max())
            assert err <= 1e-5 * float(y.float().abs().max()) + 1e-6, (i, path, err)
