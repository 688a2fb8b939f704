"""The port's training pieces against ``repro``'s on the CPU: the Markov data
stream, the schedule, AdamW and Adafactor over JAX's stacked leaves,
``cross_entropy``, checkpoints, the flash attention backward (its plain
version against ``jax.grad`` of JAX's ``attn_dense``, and the backward
kernel's tiled recurrence from the log-sum-exp against autograd), and the
guards that keep kernels without a backward out of autograd.

Tolerances: batches bit-equal; the schedule at fp32 rtol 1e-6 (numpy's
and XLA's fp32 cosines may part by an ulp); optimizer updates on identical
gradients |d| <= 1e-6 * max|x| per leaf (fp32, operations in JAX's order);
the cross entropy at rtol 1e-6; the plain flash backward against JAX's
gradient |d| <= 1e-5 * max|g| + 1e-6 (two frameworks' einsum orders); the
tiled recurrence against autograd |d| <= 1e-5 * max|g| + 1e-6."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train_loop as jax_tl  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import spec_verify as sv  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ the data
@pytest.mark.parametrize("order", [1, 2])
def test_batches_are_jaxs(order):
    kw = dict(vocab_size=300, seq_len=24, global_batch=5, seed=3, order=order)
    mine, theirs = (pipeline.batches(pipeline.DataConfig(**kw)),
                    jax_pipeline.batches(jax_pipeline.DataConfig(**kw)))
    for _ in range(4):
        a, b = next(mine), next(theirs)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        for x, y in zip(pipeline.split_batch(a), jax_pipeline.split_batch(b)):
            np.testing.assert_array_equal(x, y)
    src = pipeline.MarkovSource(pipeline.DataConfig(**kw))
    jsrc = jax_pipeline.MarkovSource(jax_pipeline.DataConfig(**kw))
    np.testing.assert_array_equal(src.succ, jsrc.succ)
    np.testing.assert_array_equal(
        src.sample(np.random.default_rng(9), 3, 40),
        jsrc.sample(np.random.default_rng(9), 3, 40))


# -------------------------------------------------------------- the schedule
@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 55, 99, 100, 130])
def test_schedule_is_jaxs(step):
    """Warmup (steps < 10), the cosine (10..100) and its end (>= 100)."""
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(jax_opt.schedule(jax_opt.AdamWConfig(**kw), jnp.asarray(step)))
    np.testing.assert_allclose(opt.schedule(opt.AdamWConfig(**kw), step), want,
                               rtol=1e-6)


# ------------------------------------------------------------- the optimizer
def _stacked_tree(arch):
    """JAX's smoke params of ``arch`` with its norm scales moved off 1 (so a
    decayed stack shows), and four seeded gradient trees like them."""
    jcfg = jax_registry.smoke_config(arch)
    jp = _to_np(jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "scale" in name:
            return (a + rng.uniform(-0.5, 0.5, a.shape)).astype(a.dtype)
        return a
    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        * np.float32(rng.uniform(1e-3, 1.0)), jp) for _ in range(3)]
    return registry.smoke_config(arch), jp, grads


def _close(port, want, what):
    for path, y in opt.leaves(want):
        x = opt.get(port, path)
        err = float((x.float() - y.float()).abs().max())
        assert err <= 1e-6 * float(y.abs().max()), (what, path, err)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama4-maverick-400b-a17b"])
def test_optimizer_over_stacked_leaves(arch, kind):
    """Three updates on identical gradients: the params after each, and
    for Adafactor the factored statistics of every leaf, JAX's to 1e-6.
    The layer norm stacks are rank 2 in JAX: AdamW decays them (a zero
    gradient still moves them) and Adafactor keeps a column statistic
    across the layers."""
    cfg, jp, grads = _stacked_tree(arch)
    tp = params_from_numpy(cfg, jp, "cpu")
    lay = opt.layout(cfg, train_loop.trainable(tp))
    by = {g.name: g for g in lay}
    assert not by["final_norm/scale"].stacked
    norms = [g for g in lay if g.name.endswith("norm/scale")
             and g.name != "final_norm/scale"]
    assert norms and all(g.stacked for g in norms)
    if kind == "adamw":
        jcfg_o, cfg_o = (jax_opt.AdamWConfig(lr=1e-2, warmup_steps=1),
                         opt.AdamWConfig(lr=1e-2, warmup_steps=1))
    else:
        jcfg_o, cfg_o = (jax_opt.AdafactorConfig(lr=1e-2, warmup_steps=1,
                                                 weight_decay=0.1),
                         opt.AdafactorConfig(lr=1e-2, warmup_steps=1,
                                             weight_decay=0.1))
    jstate = jax_opt.init_any(jcfg_o, jp)
    state = opt.init_any(cfg_o, train_loop.trainable(tp), lay)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    for i, g in enumerate(grads):
        jparams, jstate, jm = jax_opt.apply_any(
            jcfg_o, jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate)
        tp, state, m = opt.apply_any(cfg_o, tp, params_from_numpy(cfg, g, "cpu"),
                                     state, lay)
        _close(tp, params_from_numpy(cfg, _to_np(jparams), "cpu"),
               f"{kind} step {i + 1}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    if kind == "adafactor":
        flat = {jax.tree_util.keystr(p).replace("['", "").replace("']", "/")
                .rstrip("/"): (vr, vc, v)
                for (p, vr), vc, v in zip(
                    jax.tree_util.tree_leaves_with_path(jstate.vr),
                    jax.tree_util.tree_leaves(jstate.vc),
                    jax.tree_util.tree_leaves(jstate.v))}
        assert set(flat) == set(state.vr)
        for name, (vr, vc, v) in flat.items():
            for mine, theirs in ((state.vr, vr), (state.vc, vc), (state.v, v)):
                assert tuple(mine[name].shape) == theirs.shape, name
                np.testing.assert_allclose(mine[name].numpy(), np.asarray(theirs),
                                           rtol=1e-6, atol=1e-30)
        # a layer norm stack [L, D]: vc [D] is a statistic across the layers
        g = norms[0]
        assert state.vc[g.name].shape == (cfg.d_model,)
        assert state.vr[g.name].shape == (len(g.paths),)


def test_adamw_decays_stacked_norms_not_the_final_norm():
    """With zero gradients AdamW moves only what it decays: every layer's
    norm scale (stacked, rank 2 in JAX) and the matrices, not the final
    norm (rank 1)."""
    cfg = registry.smoke_config("llama3.2-1b")
    jp = _to_np(jax.jit(jax_build(jax_registry.smoke_config("llama3.2-1b")).init)(
        jax.random.PRNGKey(1)))
    tp = params_from_numpy(cfg, jp, "cpu")
    lay = opt.layout(cfg, train_loop.trainable(tp))
    zeros = opt.tree_map(torch.zeros_like, tp)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1)
    new, _, _ = opt.apply(ocfg, tp, zeros, opt.init(tp), lay)
    assert torch.equal(new["final_norm"]["scale"], tp["final_norm"]["scale"])
    for l in range(cfg.num_layers):
        assert not torch.equal(new["layers"][l]["mlp_norm"]["scale"],
                               tp["layers"][l]["mlp_norm"]["scale"])


def test_global_norm_and_cross_entropy_are_jaxs():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    np.testing.assert_allclose(
        float(train_loop.cross_entropy(torch.as_tensor(logits),
                                       torch.as_tensor(labels))),
        float(jax_tl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    tree = {"a": logits, "b": {"c": labels.astype(np.float32)}}
    np.testing.assert_allclose(
        float(opt.global_norm(jax.tree_util.tree_map(torch.as_tensor, tree))),
        float(jax_opt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
        rtol=1e-6)


# ----------------------------------------------------------- the checkpoint
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ckpt_round_trip(tmp_path, dtype):
    """Flat keys over the port's tree (lists included), bf16 stored widened
    to fp32 and restored exactly into meta ``like`` leaves, JAX's
    ``__step__``, no ``table_f32``; a shape that differs raises."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(10, 4, generator=gen).to(dtype)
    params = {"embed": {"table": table, "table_f32": table.float()},
              "layers": [{"w": torch.randn(4, 4, generator=gen).to(dtype),
                          "A_log": torch.randn(3, generator=gen)}
                         for _ in range(2)],
              "final_norm": {"scale": torch.ones(4, dtype=dtype)}}
    path = str(tmp_path / "p.npz")
    ckpt.save(path, params, step=7)
    with np.load(path) as zf:
        assert sorted(zf.files) == sorted(
            ["embed/table", "layers/0/w", "layers/0/A_log", "layers/1/w",
             "layers/1/A_log", "final_norm/scale", "__step__"])
        assert all(zf[k].dtype == np.float32 for k in zf.files if k != "__step__")
    like = opt.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), params)
    back, step = ckpt.restore(path, like, "cpu")
    assert step == 7 and "table_f32" not in back["embed"]
    for p, x in opt.leaves(params):
        y = opt.get(back, p)
        assert y.dtype == x.dtype and torch.equal(x, y), p
    ckpt.save(path, params)
    assert ckpt.restore(path, like, "cpu")[1] is None
    bad = {**like, "final_norm": {"scale": torch.empty(5, device="meta")}}
    with pytest.raises(ValueError, match="final_norm/scale"):
        ckpt.restore(path, bad, "cpu")


# ------------------------------------------------------ the flash backward
# each mask at S keys; with s_valid and a window together every row still
# sees a key (a row that sees none is undefined, in the kernels as in JAX)
MASKS = {"causal": lambda S: dict(), "window": lambda S: dict(window=5),
         "s_valid": lambda S: dict(s_valid=S - 5),
         "noncausal": lambda S: dict(causal=False),
         "noncausal_window_s_valid": lambda S: dict(causal=False, window=6,
                                                    s_valid=S - 3)}


def _qkvd(B, S, H, Kv, D, seed, Sq=None):
    rng = np.random.default_rng(seed)
    Sq = S if Sq is None else Sq
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Kv, D)).astype(np.float32),
            rng.standard_normal((B, S, Kv, D)).astype(np.float32),
            rng.standard_normal((B, Sq, H, D)).astype(np.float32))


@pytest.mark.parametrize("mask", list(MASKS))
def test_plain_flash_backward_is_jax_grad(mask):
    """``flash_attention_bwd`` on CPU tensors (the plain version: autograd
    of ``flash_attention_ref``) against ``jax.grad`` of JAX's
    ``attn_dense`` with both positions from 0 (keys at or past s_valid at
    position -1), GQA 2."""
    kw = MASKS[mask](24)
    q, k, v, do = _qkvd(2, 24, 4, 2, 16, seed=len(mask))
    s_valid = kw.get("s_valid")
    kv_pos = np.arange(24, dtype=np.int32)
    if s_valid is not None:
        kv_pos = np.where(kv_pos < s_valid, kv_pos, -1).astype(np.int32)

    def f(q_, k_, v_):
        o = jax_attention.attn_dense(q_, k_, v_, jnp.arange(24, dtype=jnp.int32),
                                     jnp.asarray(kv_pos), window=kw.get("window"),
                                     causal=kw.get("causal", True))
        return jnp.sum(o * do)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    o = fa.flash_attention(*t[:3], **kw)
    got = fa.flash_attention_bwd(*t[:3], o, None, t[3], **kw)
    for x, y in zip(got, want):
        y = np.asarray(y)
        assert float(np.abs(x.numpy() - y).max()) <= 1e-5 * np.abs(y).max() + 1e-6


@pytest.mark.parametrize("geom", [(4, 2, 16, 40), (6, 3, 8, 70), (3, 3, 8, 33),
                                  (4, 1, 8, 50)], ids=["gqa2", "gqa2_long",
                                                       "mha", "mqa"])
@pytest.mark.parametrize("mask", list(MASKS))
def test_tiled_backward_recurrence_is_autograd(geom, mask):
    """The backward kernel's recurrence (``ref.flash_attention_bwd_tiled``:
    delta, the weights recomputed per tile from the forward's log-sum-exp,
    dK/dV over the row tiles that see a key tile, dQ over the key tiles a
    row tile sees) against autograd of the plain forward, at 8- and 32-row
    tiles (rows of one kv-head's query heads split across tiles)."""
    H, Kv, D, S = geom
    kw = MASKS[mask](S)
    q, k, v, do = (torch.as_tensor(a) for a in _qkvd(2, S, H, Kv, D, seed=S + H))
    o = ref.flash_attention_ref(q, k, v, **kw)
    lse = ref.flash_attention_lse_ref(q, k, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    for tile in (8, 32):
        got = ref.flash_attention_bwd_tiled(q, k, v, o, lse, do, tile=tile, **kw)
        for x, y in zip(got, want):
            err = float((x - y).abs().max())
            assert err <= 1e-5 * float(y.abs().max()) + 1e-6, (tile, err)


@pytest.mark.parametrize("mask", ["causal", "window", "noncausal_window_s_valid"])
@pytest.mark.parametrize("H,Kv,D", [(8, 4, 48), (4, 2, 48), (4, 2, 32)],
                         ids=["pair_target", "pair_drafter", "hd32"])
def test_flash_backward_at_head_dims_32_and_48(H, Kv, D, mask):
    """The bench pair's heads (8 / 4 and 4 / 2 of 48; ``replace`` keeps
    the target's head_dim for the drafter) and d 128 over 4 / 2 at 32, at
    the recipe's training length S 48: the plain backward against
    ``jax.grad`` of JAX's ``attn_dense``, and the kernel's tiled recurrence
    from the log-sum-exp (32-row tiles, as the kernel's) against
    autograd, both to |d| <= 1e-5 * max|g| + 1e-6."""
    S = 48
    kw = MASKS[mask](S)
    q, k, v, do = _qkvd(2, S, H, Kv, D, seed=H + D + len(mask))
    s_valid = kw.get("s_valid")
    kv_pos = np.arange(S, dtype=np.int32)
    if s_valid is not None:
        kv_pos = np.where(kv_pos < s_valid, kv_pos, -1).astype(np.int32)

    def f(q_, k_, v_):
        o = jax_attention.attn_dense(q_, k_, v_, jnp.arange(S, dtype=jnp.int32),
                                     jnp.asarray(kv_pos), window=kw.get("window"),
                                     causal=kw.get("causal", True))
        return jnp.sum(o * do)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    o = fa.flash_attention(*t[:3], **kw)
    lse = ref.flash_attention_lse_ref(*t[:2], **kw)
    plain = fa.flash_attention_bwd(*t[:3], o, None, t[3], **kw)
    tiled = ref.flash_attention_bwd_tiled(*t[:3], o, lse, t[3], tile=32, **kw)
    for x, z, y in zip(plain, tiled, want):
        y = np.asarray(y)
        tol = 1e-5 * np.abs(y).max() + 1e-6
        assert float(np.abs(x.numpy() - y).max()) <= tol
        assert float(np.abs(z.numpy() - y).max()) <= tol


def test_lse_ref_normalises_the_weights():
    """exp(scaled score - lse) over each row's visible keys sums to 1."""
    q, k, _, _ = (torch.as_tensor(a) for a in _qkvd(1, 30, 4, 2, 8, seed=2))
    lse = ref.flash_attention_lse_ref(q, k, window=7)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(1, 30, 2, 2, 8), k) * 8 ** -0.5
    pos = torch.arange(30)
    vis = (pos[:, None] >= pos[None, :]) & ((pos[:, None] - pos[None, :]) < 7)
    p = torch.where(vis, torch.exp(s - lse.reshape(1, 2, 2, 30)[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(1, 2, 2, 30))


def test_flash_attention_on_cpu_differentiates():
    """A CPU call is the plain version, which autograd differentiates."""
    q, k, v, do = (torch.as_tensor(a) for a in _qkvd(1, 12, 2, 1, 8, seed=4))
    qg = q.clone().requires_grad_(True)
    fa.flash_attention(qg, k, v).backward(do)
    torch.testing.assert_close(qg.grad, ref.flash_attention_bwd_ref(q, k, v, do)[0])


# ---------------------------------------------------------------- the guards
def _meta(*shape, dtype=torch.float32, grad=False):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.requires_grad_(True) if grad else t


GUARDED = {
    "paged_attention": lambda g: pa.paged_flash_attention(
        _meta(1, 1, 2, 64, grad=g), _meta(4, 16, 1, 64), _meta(4, 16, 1, 64),
        _meta(1, 4, dtype=torch.int32), 0),
    "tree_attention": lambda g: ta.tree_flash_attention(
        _meta(1, 3, 2, 64, grad=g), _meta(4, 16, 1, 64), _meta(4, 16, 1, 64),
        _meta(1, 4, dtype=torch.int32), 0, torch.zeros(3, dtype=torch.int32),
        torch.zeros(3, dtype=torch.int32)),
    "blockwise_argmax": lambda g: sv.blockwise_argmax(_meta(2, 100, grad=g)),
    "int8_matmul": lambda g: im.int8_matmul(
        _meta(32, 16, dtype=torch.int8), _meta(16, 8, dtype=torch.int8),
        _meta(grad=g), _meta(8)),
    "ssd_scan": lambda g: ss.ssd_scan(_meta(1, 8, 2, 4, grad=g), _meta(1, 8, 2),
                                      _meta(1, 8, 2, 4), _meta(1, 8, 2, 4)),
}


@pytest.mark.parametrize("name", list(GUARDED))
def test_kernels_without_a_backward_refuse_grad(name):
    """Every wrapper but flash attention's, off the CPU, raises under grad
    mode when an input requires grad (here on meta tensors, which take the
    kernel branch), and not otherwise (the launch checks then refuse the
    meta device)."""
    with pytest.raises(RuntimeError, match="no backward"):
        GUARDED[name](True)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        GUARDED[name](True)
    with pytest.raises(ValueError, match="device"):
        GUARDED[name](False)


def test_check_no_grad():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan: the kernel has no backward"):
        build.check_no_grad("ssd_scan", torch.zeros(2), None, x)
    with torch.no_grad():
        build.check_no_grad("ssd_scan", x)
    build.check_no_grad("ssd_scan", torch.zeros(2), None)


def test_training_modules_read_time_through_the_clock():
    """``launch/train.py`` and the training package read time only through
    ``obs.clock`` (the CI rule over the JAX package, held on the port)."""
    files = [ROOT / "src/repro_torch/launch/train.py",
             *sorted((ROOT / "src/repro_torch/training").glob("*.py")),
             *sorted((ROOT / "src/repro_torch/data").glob("*.py")),
             *sorted((ROOT / "src/repro_torch/checkpoint").glob("*.py"))]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                assert all(a.name != "time" for a in node.names), path
            if isinstance(node, ast.ImportFrom):
                assert node.module != "time", path
    assert "clock.wall()" in (ROOT / "src/repro_torch/launch/train.py").read_text()
