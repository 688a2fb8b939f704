"""Weight bridge: JAX-initialised params (as numpy) -> the port's params.

The JAX models (all six families) keep their params as a nested
dict with the layer params stacked on axis 0. A caller that holds both packages turns
that tree into numpy (``jax.tree_util.tree_map(np.asarray, params)``) and
hands it here; this module itself never imports JAX. Layers are unstacked
into a list of per-layer dicts; linear weights keep JAX's ``[d_in, d_out]``
layout (and conv weights JAX's ``[K, CH]``), because the port computes as
JAX does. Trees from ``quantize_for_serving`` cross too.

The moe family stacks each block kind on its own (``layers["dense{j}"]``
and ``layers["moe"]``, each [n_blocks, ...]; experts [E, ...] inside); the
port's list interleaves them in forward order, ``dense0[i] ...
dense{m-2}[i], moe[i]`` for block i (``models.moe``). The hybrid family
stacks each unit of its pattern over the blocks (``blocks["u{j}_{kind}"]``,
each [n_blocks, ...]) and keeps the leftover units in a ``tail`` list; the
port's list is block i's units in pattern order, then the tail
(``models.hybrid``). The VLM's tree is the dense tree plus the
``projector`` (unstacked leaves). The encoder-decoder stacks
``enc_layers`` and ``dec_layers`` (``self``/``cross``/``mlp``/
``mlp_norm``) on axis 0; the port keeps each as a list in forward order
(``models.encdec``), beside ``enc_norm`` and the tied embedding.

Each leaf keeps its dtype class: fp32 leaves stay fp32 (the SSM's
``A_log``, ``D`` and ``dt_bias`` and the RG-LRU's ``lam`` are fp32
whatever the param dtype, and rounding them would change the decay),
integer leaves keep their type (the int8 ``w_q``), and the other float
leaves (bf16) take ``cfg.weight_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.models import hybrid
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

    def layer(stack, i):
        return _map(lambda a: to_torch(np.asarray(a)[i]), stack)

    def stack(name, n_want):
        n = _leaves(tree[name])[0].shape[0]
        if n != n_want:
            raise ValueError(f"tree has {n} {name}, config {n_want}")
        return [layer(tree[name], i) for i in range(n)]

    if cfg.family == "encdec":
        return {"embed": L.with_f32_table({"table": to_torch(tree["embed"]["table"])}),
                "enc_layers": stack("enc_layers", cfg.num_encoder_layers),
                "enc_norm": _map(to_torch, tree["enc_norm"]),
                "dec_layers": stack("dec_layers", cfg.num_layers),
                "final_norm": _map(to_torch, tree["final_norm"])}
    if cfg.family == "moe":
        m = max(cfg.moe_every, 1)
        kinds = [f"dense{j}" for j in range(m - 1)] + ["moe"]
        if sorted(tree["layers"]) != sorted(kinds):
            raise ValueError(f"moe tree holds blocks {sorted(tree['layers'])}, "
                             f"config {kinds}")
        n = _leaves(tree["layers"]["moe"])[0].shape[0]
        if n != cfg.num_layers // m:
            raise ValueError(f"tree has {n} blocks, config "
                             f"{cfg.num_layers // m}")
        layers = [layer(tree["layers"][k], i) for i in range(n) for k in kinds]
    elif cfg.family == "hybrid":
        layers = _hybrid_layers(cfg, tree, layer, to_torch)
    else:
        layers = stack("layers", cfg.num_layers)
    params = {
        "embed": {"table": to_torch(tree["embed"]["table"])},
        "layers": layers,
        "final_norm": {"scale": to_torch(tree["final_norm"]["scale"])},
    }
    if cfg.tie_embeddings or cfg.family == "hybrid":   # hybrid always ties
        params["embed"] = L.with_f32_table(params["embed"])
    else:
        params["lm_head"] = _map(to_torch, tree["lm_head"])
    if cfg.family == "vlm":
        params["projector"] = _map(to_torch, tree["projector"])
    return params


def _hybrid_layers(cfg, tree, layer, to_torch):
    """JAX's hybrid ``blocks`` (each unit stacked over the blocks) and
    ``tail`` as the port's flat list of units in forward order."""
    n_blocks, pat, tail = hybrid.layout(cfg)
    keys = [f"u{j}_{kind}" for j, kind in enumerate(pat)]
    if sorted(tree["blocks"]) != sorted(keys):
        raise ValueError(f"hybrid tree holds units {sorted(tree['blocks'])}, "
                         f"config {keys}")
    n = _leaves(tree["blocks"])[0].shape[0]
    got_tail = len(tree.get("tail", []))
    if n != n_blocks or got_tail != len(tail):
        raise ValueError(f"tree has {n} blocks and {got_tail} tail units, "
                         f"config {n_blocks} and {len(tail)}")
    layers = [layer(tree["blocks"][k], i) for i in range(n) for k in keys]
    return layers + [_map(to_torch, unit) for unit in tree.get("tail", [])]
