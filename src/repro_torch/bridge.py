"""Weight bridge: JAX-initialised params (as numpy) -> the port's params.

The JAX models (dense and ssm) keep their params as a nested dict with the
layer params stacked on axis 0. A caller that holds both packages turns
that tree into numpy (``jax.tree_util.tree_map(np.asarray, params)``) and
hands it here; this module itself never imports JAX. Layers are unstacked
into a list of per-layer dicts; linear weights keep JAX's ``[d_in, d_out]``
layout (and conv weights JAX's ``[K, CH]``), because the port computes as
JAX does. Trees from ``quantize_for_serving`` cross too.

Each leaf keeps its dtype class: fp32 leaves stay fp32 (the SSM's
``A_log``, ``D`` and ``dt_bias`` are fp32 whatever the param dtype, and
rounding them would change the decay), integer leaves keep their type (the
int8 ``w_q``), and the other float leaves (bf16) take ``cfg.weight_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.models import layers as L


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [np.asarray(tree)]


def params_from_numpy(cfg, tree, device=None):
    """Port params for ``cfg`` from the JAX param tree ``tree`` (numpy
    leaves; bfloat16 leaves are widened through float32, which is exact)."""
    dev = devices.resolve(device)

    def to_torch(a):
        # torch.tensor copies: the port never aliases the caller's arrays
        a = np.asarray(a)
        if a.dtype.kind in "iub":
            return torch.tensor(a, device=dev)
        dt = torch.float32 if a.dtype == np.float32 else cfg.weight_dtype
        return torch.tensor(a.astype(np.float32), dtype=dt, device=dev)

    n = _leaves(tree["layers"])[0].shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.num_layers}")
    params = {
        "embed": {"table": to_torch(tree["embed"]["table"])},
        "layers": [_map(lambda a, i=i: to_torch(np.asarray(a)[i]), tree["layers"])
                   for i in range(n)],
        "final_norm": {"scale": to_torch(tree["final_norm"]["scale"])},
    }
    if cfg.tie_embeddings:
        params["embed"] = L.with_f32_table(params["embed"])
    else:
        params["lm_head"] = _map(to_torch, tree["lm_head"])
    return params
