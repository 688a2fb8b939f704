"""Checkpointing: flat-key npz of the port's param tree (port of
``repro/checkpoint/ckpt.py``; no external deps).

A key is the leaf's path in the port's own tree, dict keys and list
indices joined by "/" (``layers/3/attn/q/w``), beside JAX's ``__step__``.
numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf is written
widened to fp32, which is exact; ``restore`` casts every leaf to the dtype
of ``like``, as JAX's ``restore`` does, and checks its shape. The serving
copy of a tied table (``table_f32``) is never written: it is derived.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.training.optimizer import leaves


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save(path: str, params: Any, step: Optional[int] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"/".join(map(str, key)): _to_numpy(leaf)
            for key, leaf in leaves(params)}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)


def restore(path: str, like: Any, device=None):
    """Restore into the structure of ``like`` (a tree of tensors; meta
    tensors will do): each leaf in the dtype and shape of ``like``'s, on
    ``device`` (default cuda; ``"cpu"`` to stay on the host). Returns
    (tree, step or None). A ``table_f32`` in ``like`` is left out."""
    dev = devices.resolve(device)
    with np.load(path) as zf:
        data = {k: zf[k] for k in zf.files}

    def fill(tree, path):
        if isinstance(tree, dict):
            return {k: fill(v, path + (str(k),)) for k, v in tree.items()
                    if k != "table_f32"}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v, path + (str(i),))
                              for i, v in enumerate(tree))
        key = "/".join(path)
        arr = data[key]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(tree.shape)}")
        return torch.from_numpy(arr).to(device=dev, dtype=tree.dtype)

    tree = fill(like, ())
    step = int(data["__step__"]) if "__step__" in data else None
    return tree, step
