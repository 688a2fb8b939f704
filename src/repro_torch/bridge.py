"""Weight bridge: JAX-initialised params (as numpy) -> the port's params.

The JAX dense model keeps its params as a nested dict with the layer
params stacked on axis 0. A caller that holds both packages turns that
tree into numpy (``jax.tree_util.tree_map(np.asarray, params)``) and hands
it here; this module itself never imports JAX. Layers are unstacked into a
list of per-layer dicts; linear weights keep JAX's ``[d_in, d_out]``
layout, because the port computes ``x @ w`` as JAX does.
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


def params_from_numpy(cfg, tree, device=None):
    """Port params for ``cfg`` from the JAX param tree ``tree`` (numpy
    leaves; bfloat16 leaves are widened through float32, which is exact)."""
    dev = devices.resolve(device)
    dt = cfg.weight_dtype

    def to_torch(a):
        # torch.tensor copies: the port never aliases the caller's arrays
        return torch.tensor(np.asarray(a, dtype=np.float32), dtype=dt, device=dev)

    n = np.asarray(tree["layers"]["attn"]["q"]["w"]).shape[0]
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
        params["lm_head"] = {"w": to_torch(tree["lm_head"]["w"])}
    return params
