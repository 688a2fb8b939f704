"""The port's training path against ``repro``'s on the CPU: the loss and
its gradients for every family's smoke config, the train step over three
steps (one microbatch and two), activation checkpointing, the tied table,
and ``launch.train`` end to end.

Params come from JAX's init through ``bridge.params_from_numpy``; tokens
and the modality stand-ins are seeded numpy. Gradients cross back through
the same bridge, so each port tensor is held to its slice of JAX's stacked
leaf.

Tolerances: losses at fp32 rtol 1e-5; gradients per leaf |d| <= 1e-4 *
max|g| + 1e-6 (XLA and PyTorch sum the products in different orders);
params after each of three train steps |d| <= 1e-5 * max|p| + 1e-6 per
leaf (AdamW's eps raised to 1e-4 there, see that test);
remat on against remat off bit-equal (the same ops run again)."""
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
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

# one smoke config of each family; Llama 4 Maverick's interleaves a dense
# block and a MoE block, RecurrentGemma's (5 units) has a tail
ARCHS = ("llama3.2-1b", "mixtral-8x7b", "llama4-maverick-400b-a17b",
         "mamba2-780m", "recurrentgemma-2b", "internvl2-26b",
         "whisper-large-v3")
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, seed=0, **kw):
    jcfg = jax_registry.smoke_config(arch).replace(**kw)
    cfg = registry.smoke_config(arch).replace(**kw)
    jm, m = jax_build(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    return jcfg, cfg, jm, m, jp, params_from_numpy(cfg, _to_np(jp), "cpu")


def _batch(jm, cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for k, sds in jm.extra_inputs(b).items():
        batch[k] = rng.standard_normal(sds.shape).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _extras(batch):
    return {k: v for k, v in batch.items() if k not in ("tokens", "labels")}


def _assert_tree_close(cfg, port, jax_tree, rel, what):
    want = params_from_numpy(cfg, _to_np(jax_tree), "cpu")
    paths = [p for p, _ in opt.leaves(want)]
    assert sorted(map(str, paths)) == sorted(str(p) for p, _ in opt.leaves(port))
    for path in paths:
        x, y = opt.get(port, path).float(), opt.get(want, path).float()
        err = float((x - y).abs().max())
        tol = rel * float(y.abs().max()) + 1e-6
        assert err <= tol, (what, path, err, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` (MoE aux terms included) and its gradient per leaf
    against ``jax.value_and_grad`` of JAX's ``loss_fn``."""
    _, cfg, jm, m, jp, tp = _setup(arch)
    batch = _batch(jm, cfg, 1)
    jb = _jax(batch)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_tl.loss_fn(jm, p, jb["tokens"], jb["labels"], _extras(jb)),
        has_aux=True))(jp)
    tb = _torch(batch)
    loss, met, grads = train_loop.value_and_grad(m, tp, tb["tokens"],
                                                 tb["labels"], _extras(tb))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    _assert_tree_close(cfg, grads, jg, 1e-4, "grad")


@pytest.mark.parametrize("nmb", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama4-maverick-400b-a17b"])
def test_train_step_matches_jax(arch, nmb):
    """Three AdamW steps of ``make_train_step`` (warmup 2, so the third is
    on the cosine) against JAX's jitted step: the losses, the metric keys
    (``ce`` only when microbatched) and the params after each step. AdamW's
    eps is 1e-4 here: at the default 1e-8 the normalised update g / (|g| +
    eps) of an element whose gradient is near 1e-8 turns the two
    frameworks' last-bit gradient differences into a sizeable share of
    the step (3.6e-4 against lr 5e-3 at one element); the update
    arithmetic itself is held to 1e-6 on identical gradients in
    test_torch_training.py."""
    _, cfg, jm, m, jp, tp = _setup(arch, embed_init_scale=0.1)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=3, eps=1e-4)
    jstep = jax.jit(jax_tl.make_train_step(jm, jax_opt.AdamWConfig(**ocfg), nmb))
    step = train_loop.make_train_step(m, opt.AdamWConfig(**ocfg), nmb)
    js = jax_opt.init(jp)
    ts = train_loop.init_opt_state(m, opt.AdamWConfig(**ocfg), tp)
    for i in range(3):
        batch = _batch(jm, cfg, 10 + i, b=4)
        jp, js, jmet = jstep(jp, js, _jax(batch))
        tp, ts, met = step(tp, ts, _torch(batch))
        assert set(met) == set(jmet)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
        _assert_tree_close(cfg, tp, jp, 1e-5, f"params after step {i + 1}")
    assert ts.step == int(js.step) == 3
    if nmb == 2:
        assert set(met) == {"ce", "grad_norm", "lr", "loss"}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch, policy):
    """Checkpointing every no-cache layer recomputes the same ops: the loss
    and every gradient are bit-equal to the run without it."""
    _, cfg, jm, m, _, tp = _setup(arch)
    mr = build_model(cfg.replace(remat=True, remat_policy=policy))
    tb = _torch(_batch(jm, cfg, 2))
    args = (tb["tokens"], tb["labels"], _extras(tb))
    l0, _, g0 = train_loop.value_and_grad(m, tp, *args)
    l1, _, g1 = train_loop.value_and_grad(mr, tp, *args)
    assert torch.equal(l0, l1)
    for path, x in opt.leaves(g0):
        assert torch.equal(x, opt.get(g1, path)), path


def test_remat_recomputes_under_grad_only():
    """A checkpointed layer runs once per forward outside grad mode, twice
    in a forward and backward (the recompute), for both policies."""
    cfg = registry.smoke_config("llama3.2-1b").replace(remat=True)
    calls = []

    def layer(x):
        calls.append(1)
        return torch.tanh(x @ x.T) @ x

    x = torch.randn(4, 4, requires_grad=True)
    for policy in ("full", "dots"):
        wrapped = L.remat_wrap(layer, cfg.replace(remat_policy=policy))
        calls.clear()
        with torch.no_grad():
            wrapped(x)
        assert len(calls) == 1
        calls.clear()
        wrapped(x).sum().backward()
        assert len(calls) == 2
    with pytest.raises(ValueError, match="remat_policy"):
        L.remat_wrap(layer, cfg.replace(remat_policy="offload"))


def test_tied_table_gets_both_gradients_and_no_copy(tmp_path):
    """A bf16 tied model: its params carry the serving copy ``table_f32``.
    Under grad the unembedding reads ``table`` itself, so the table's
    gradient holds the unembedding's part (rows of ids absent from the
    input) and the embedding's (it matches the fp32 model's at bf16
    rounding); ``table_f32`` is in no gradient, optimizer state or
    checkpoint, and ``serving_params`` makes a fresh copy of the trained
    table."""
    cfg = registry.smoke_config("llama3.2-1b").replace(
        dtype="bfloat16", param_dtype="bfloat16", embed_init_scale=0.1)
    m = build_model(cfg)
    params = m.init(3, "cpu")
    assert "table_f32" in params["embed"]
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size // 2, (2, 17)))
    loss, _, grads = train_loop.value_and_grad(m, params, toks[:, :-1], toks[:, 1:])
    assert "table_f32" not in grads["embed"]
    g = grads["embed"]["table"].float()
    assert g.dtype == torch.float32 and grads["embed"]["table"].dtype == torch.bfloat16
    assert float(g[cfg.vocab_size // 2:].abs().max()) > 0     # unembedding only
    # the embedding's part: the same gradient with the lookup's share taken
    # out (an fp32 model on the same weights) differs on the input rows
    f32 = build_model(cfg.replace(dtype="float32", param_dtype="float32"))
    p32 = opt.tree_map(lambda t: t.float(), params)
    _, _, g32 = train_loop.value_and_grad(f32, p32, toks[:, :-1], toks[:, 1:])
    ref = g32["embed"]["table"]
    assert float((g - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
    ocfg = opt.AdamWConfig()
    state = train_loop.init_opt_state(m, ocfg, params)
    assert "table_f32" not in state.mu["embed"] and "table_f32" not in state.nu["embed"]
    lay = opt.layout(cfg, train_loop.trainable(params))
    assert all("table_f32" not in g.name for g in lay)
    step = train_loop.make_train_step(m, ocfg)
    new, state, _ = step(params, state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert "table_f32" not in new["embed"]
    assert not torch.equal(new["embed"]["table"], params["embed"]["table"])
    ckpt.save(str(tmp_path / "t.npz"), params, step=1)
    with np.load(tmp_path / "t.npz") as zf:
        assert not any("table_f32" in k for k in zf.files)
    served = train_loop.serving_params(new)
    assert torch.equal(served["embed"]["table_f32"], new["embed"]["table"].float())
    # the serving unembedding reads the copy; under grad, the table
    x = torch.randn(1, 2, cfg.d_model)
    with torch.no_grad():
        assert torch.equal(L.unembed(served["embed"], x),
                           x @ served["embed"]["table_f32"].T)


def test_launch_train_smoke_main(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch llama3.2-1b --smoke
    --device cpu`` for 30 steps through ``main``: JAX's lines, the loss
    falling, and a checkpoint that restores into the trained params."""
    path = tmp_path / "smoke.npz"
    params, losses = train_cli.main(
        ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "30",
         "--batch", "4", "--seq", "32", "--lr", "3e-3", "--ckpt", str(path)])
    out = capsys.readouterr().out
    assert out.startswith("training llama3.2-1b-smoke (dense) params~")
    assert "step     0 loss" in out and "step    29 loss" in out
    assert f"saved {path}" in out
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    like = opt.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), params)
    back, step = ckpt.restore(str(path), like, "cpu")
    assert step == 30
    for p, x in opt.leaves(params):
        assert torch.equal(x, opt.get(back, p))
