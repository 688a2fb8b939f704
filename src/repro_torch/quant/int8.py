"""w8a8 static quantization (paper §III-C; port of ``repro/quant/int8.py``).

Weights: per-output-channel symmetric int8. Activations: per-tensor
symmetric int8. Two execution paths with matching semantics:

  * fake-quant (QDQ) — quantize->dequantize in the original dtype; the
    paper's acceptance-rate-vs-quantization study (Fig. 5).
  * integer path — int8 x int8 -> int32 matmul + rescale epilogue, the
    deployment path: ``quantize_for_serving`` weights under ``act_quant``
    reach ``kernels.ops.quantized_matmul`` from ``models.layers.linear``
    (the CUDA kernel ``csrc/int8_matmul.cu`` on the card).

Activation quantization is toggled process-wide via ``act_quant(...)``; the
hook lives in ``models.layers.linear``, so every family picks it up. The
scale is static when one is given and otherwise the dynamic amax over the
whole input tensor (all rows and positions), exactly as in JAX: a per-row
scale would be another function. A static scale is made on the device
(``torch.full``), so the hook never synchronises the stream.

The parameter trees hold per-layer lists where JAX stacks layers on axis
0. ``quantize_params`` visits the entries of such a list together, as one
stacked leaf, so its per-channel scales are shared across layers as JAX's
are; ``quantize_for_serving`` reduces over K only and is per layer in both.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch


# ----------------------------------------------------------------- primitives
def quantize_array(w, axis: Optional[int] = -1, bits: int = 8):
    """Symmetric quantization. axis: per-channel scale axis (None = per-tensor)."""
    qmax = 2.0 ** (bits - 1) - 1
    wf = w.float()
    if axis is None:
        amax = wf.abs().amax()
    else:
        dims = tuple(i for i in range(wf.ndim) if i != axis % wf.ndim)
        amax = wf.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(amax / qmax, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.float()


def dequantize(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def fake_quant(w, axis: Optional[int] = -1, bits: int = 8):
    q, s = quantize_array(w, axis, bits)
    return dequantize(q, s, w.dtype)


# ------------------------------------------------------------- model weights
def _is_matmul_weight(path_str: str, leaf) -> bool:
    return path_str.endswith("/w") and leaf.ndim >= 2


def _map_stacked(nodes, path, fn):
    """Map ``fn(path, leaves) -> new leaves`` over parallel subtrees
    ``nodes``. A list (the per-layer params) turns its entries into one
    such parallel set, so a stacked leaf is handed to ``fn`` as the list of
    its per-layer leaves; ``path`` is JAX's path string (no list index)."""
    first = nodes[0]
    if isinstance(first, dict):
        out = [{} for _ in nodes]
        for k in first:
            sub = _map_stacked([n[k] for n in nodes], f"{path}/{k}" if path else k, fn)
            for o, v in zip(out, sub):
                o[k] = v
        return out
    if isinstance(first, list):
        if len(nodes) != 1:
            raise ValueError(f"nested per-layer lists at {path!r}")
        return [_map_stacked(first, path, fn)]
    return fn(path, nodes)


def quantize_params(params, bits: int = 8, predicate: Optional[Callable] = None):
    """Fake-quantize (QDQ) every matmul weight; embeddings/norms stay fp.

    The paper's 'quantized target / quantized drafter' treatment for the
    acceptance-rate study: same tree structure, shifted distribution. A
    per-layer weight is quantized stacked with its siblings ([L, K, N],
    the scale reduced over L and K), and ``predicate(path, leaf)`` sees
    that stacked leaf, as in JAX."""
    pred = predicate or _is_matmul_weight

    def rule(path, leaves):
        w = torch.stack(leaves) if len(leaves) > 1 else leaves[0]
        if not pred(path, w):
            return leaves
        w = fake_quant(w, axis=-1, bits=bits)
        return list(w.unbind(0)) if len(leaves) > 1 else [w]

    return _map_stacked([params], "", rule)[0]


# --------------------------------------------------------- activation quant
_ACT_QUANT = {"enabled": False, "bits": 8, "static_scale": None}


@contextlib.contextmanager
def act_quant(enabled: bool = True, bits: int = 8, static_scale: Optional[float] = None):
    """Enable activation quantization inside layers.linear for the dynamic extent."""
    prev = dict(_ACT_QUANT)
    _ACT_QUANT.update(enabled=enabled, bits=bits, static_scale=static_scale)
    try:
        yield
    finally:
        _ACT_QUANT.update(prev)


def act_quant_enabled() -> bool:
    return _ACT_QUANT["enabled"]


def quantize_act(x):
    """Per-tensor activation quantization under the current ``act_quant``
    settings: (q, scale) with q = clip(round(x / scale), -qmax-1, qmax) as
    fp32 integers and scale a 0-dim fp32 tensor on x's device."""
    bits = _ACT_QUANT["bits"]
    qmax = 2.0 ** (bits - 1) - 1
    xf = x.float()
    if _ACT_QUANT["static_scale"] is not None:
        scale = torch.full((), _ACT_QUANT["static_scale"], dtype=torch.float32,
                           device=x.device)
    else:
        scale = torch.clamp_min(xf.abs().amax() / qmax, 1e-12)
    return torch.clamp(torch.round(xf / scale), -qmax - 1, qmax), scale


def int8_act(x):
    """``quantize_act`` for the integer path: (int8 q, scale). Raises when
    the configured bits do not fit int8."""
    if _ACT_QUANT["bits"] > 8:
        raise ValueError("the int8 path quantizes activations to at most 8 bits")
    q, scale = quantize_act(x)
    return q.to(torch.int8), scale


def maybe_quant_act(x):
    """Called from models.layers.linear on every matmul input (fake-quant)."""
    if not _ACT_QUANT["enabled"]:
        return x
    q, scale = quantize_act(x)
    return (q * scale).to(x.dtype)


def calibrate_act_scale(samples, bits: int = 8, percentile: float = 99.9) -> float:
    """Offline static calibration: percentile absmax over activation samples
    (tensors on any device, or arrays)."""
    qmax = 2.0 ** (bits - 1) - 1
    vals = np.concatenate([np.abs(_to_numpy(s)).ravel() for s in samples])
    return float(np.percentile(vals, percentile) / qmax)


def _to_numpy(s):
    if isinstance(s, torch.Tensor):
        return s.detach().float().cpu().numpy()
    return np.asarray(s, np.float32)


def quantize_for_serving(params):
    """Replace every matmul weight leaf {"w": [..., K, N]} with
    {"w_q": int8, "scale": f32 per-output-channel} (a new tree; the input
    is left as it is). Embedding tables stay as they are (gather path)."""

    def walk(node):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) >= 2:
                # per-output-channel: reduce over the K (contraction) dim ONLY
                wf = node["w"].float()
                amax = wf.abs().amax(dim=-2, keepdim=True)
                sc = torch.clamp_min(amax / 127.0, 1e-12)
                q = torch.clamp(torch.round(wf / sc), -128, 127).to(torch.int8)
                rest = {k: walk(v) for k, v in node.items() if k != "w"}
                return {"w_q": q, "scale": sc[..., 0, :].float(), **rest}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
