"""The repo's own trained pair (``benchmarks/common.py``: the target 6
layers of d 384 over 8 / 4 heads, the drafter 2 layers of d 128 over 4 / 2)
at its own geometry in the port, against ``repro`` on the CPU.

``chip_smoke.py::pair_configs`` (the pair the card trains and serves) must
be the recipe field for field. The drafter is the target's config
``replace``d, so it keeps the target's derived head_dim: 4 / 2 heads of 48
(q 128 -> 192), in both frameworks. Then ``launch.train.train``'s losses
equal JAX's ``launch.train.train`` over three steps from one init (the
port's init swapped for JAX's, bridged), at fp32 rtol 1e-5 (at the
default AdamW eps the two frameworks' last-bit gradient differences can
move an element whose gradient is near 0 by up to the learning rate; the
loss moves far less). The pair's serving paths are
``test_torch_bench_pair_serving.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _serving_parity import bench_pair_configs, one_torch_thread  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def test_pair_configs_are_the_recipe():
    """Every field JAX's config has, equal in the port's; head_dim 48 for
    both models; the drafter's q projection 128 -> 192 in both inits."""
    (jt, jd), (t, d) = bench_pair_configs()
    for jcfg, cfg in ((jt, t), (jd, d)):
        for f in dataclasses.fields(jcfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (t.num_heads, t.num_kv_heads, t.head_dim) == (8, 4, 48)
    assert (d.num_heads, d.num_kv_heads, d.head_dim) == (4, 2, 48)
    jp = jax_build(jd).init(jax.random.PRNGKey(1))
    assert jp["layers"]["attn"]["q"]["w"].shape == (2, 128, 192)
    assert build_model(d).init(1, "cpu")["layers"][0]["attn"]["q"]["w"].shape == (128, 192)


class _JaxInit:
    """The port's model with JAX's init at the seed ``launch.train`` asks
    for (bridged), so both trainings start from the same weights."""

    def __init__(self, model, jax_model):
        self.model, self.jax_model = model, jax_model

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init(self, seed, device):
        jp = self.jax_model.init(jax.random.PRNGKey(seed))
        return params_from_numpy(self.model.cfg,
                                 jax.tree_util.tree_map(np.asarray, jp), device)


@pytest.mark.parametrize("which,seed", [(0, 0), (1, 1)], ids=["target", "drafter"])
def test_launch_train_matches_jax(which, seed, monkeypatch):
    """Three steps of the recipe's training (order-1 Markov data, data seed
    0, lr 2e-3) at batch 2 x 16 tokens: the port's ``launch.train.train``
    against JAX's, step by step."""
    jcfg, cfg = (c[which] for c in bench_pair_configs())
    monkeypatch.setattr(train_cli, "build_model",
                        lambda c: _JaxInit(build_model(c), jax_build(jcfg)))
    kw = dict(steps_n=3, batch=2, seq=16, lr=2e-3, seed=seed, log_every=100,
              data_seed=0, data_order=1)
    _, jlosses = jax_train.train(jcfg, **kw)
    _, losses = train_cli.train(cfg, device="cpu", **kw)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
