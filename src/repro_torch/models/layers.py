"""Shared neural-net primitives (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors, as in the JAX package, and
every function is a plain function on tensors. Linear weights keep JAX's
``[d_in, d_out]`` layout (``x @ w``), so weights cross the bridge
unchanged. ``linear`` carries the w8a8 hooks of ``quant.int8`` (off by
default, as in JAX). ``remat_wrap`` is JAX's activation checkpointing of
a layer, for training.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.quant import int8 as q8


# --------------------------------------------------------------------------- init
def _dense_init(gen: torch.Generator, shape, dtype, device, scale=None):
    """Truncated-normal fan-in init (matches the JAX init's distribution;
    the numbers differ, since torch and jax generators differ)."""
    if torch.device(device).type == "meta":     # shapes only: nothing drawn
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def init_linear(gen, d_in, d_out, dtype, device, scale=None):
    return {"w": _dense_init(gen, (d_in, d_out), dtype, device, scale)}


def linear(p, x):
    """``x @ w``, with the w8a8 paths of ``quant.int8``:

    * int8 weights (``quantize_for_serving``) under ``act_quant``: x is
      quantized per tensor and ``kernels.ops.quantized_matmul`` computes
      ``(q_x @ w_q) * sx * scale`` — the int8 kernel on the card, its plain
      version on the CPU. JAX instead multiplies the dequantized operands,
      ``(q_x * sx)_dtype @ (w_q * scale)_dtype``: the same in fp32 up to
      rounding (~1e-6 relative), apart by the operands' roundings in bf16.
      The port computes what the TPU kernel computes.
    * int8 weights without act-quant (w8a16): dequantize, then ``x @ w``.
    * float weights: fake-quant x when act-quant is on, then ``x @ w``."""
    if "w_q" in p:
        if q8.act_quant_enabled():
            from repro_torch.kernels import ops
            q, sx = q8.int8_act(x)
            return ops.quantized_matmul(q, p["w_q"], sx, p["scale"],
                                        out_dtype=x.dtype)
        w = p["w_q"].to(x.dtype) * p["scale"].to(x.dtype)
        return x @ w
    x = q8.maybe_quant_act(x)
    return x @ p["w"].to(x.dtype)


def init_rmsnorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


# --------------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # built from device ops only: a host scalar copied to the card here
    # would synchronise the stream twice per layer
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return torch.pow(float(theta), exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # [D/2]
    angles = positions[..., None].float() * freqs                    # [..., S, D/2]
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- MLP
def init_swiglu(gen, d_model, d_ff, dtype, device):
    return {
        "gate": init_linear(gen, d_model, d_ff, dtype, device),
        "up": init_linear(gen, d_model, d_ff, dtype, device),
        "down": init_linear(gen, d_ff, d_model, dtype, device),
    }


def swiglu(p, x):
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


def init_gelu_mlp(gen, d_model, d_ff, dtype, device):
    return {"up": init_linear(gen, d_model, d_ff, dtype, device),
            "down": init_linear(gen, d_ff, d_model, dtype, device)}


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's default
    is the erf form, which parts from it by ~1e-3)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(p, x):
    return linear(p["down"], gelu(linear(p["up"], x)))


# --------------------------------------------------------------------------- embeddings
def init_embedding(gen, vocab, d_model, dtype, device, scale: Optional[float] = None):
    """``scale=None`` keeps the std-1.0 table, as the JAX init does."""
    return {"table": _dense_init(gen, (vocab, d_model), dtype, device,
                                 scale=1.0 if scale is None else scale)}


def with_f32_table(p):
    """Add the fp32 copy of a narrower embedding table that the tied
    unembedding reads when serving (computed once instead of on every
    call). Training never reads it (``unembed``): trained params get a
    fresh copy (``training.train_loop.serving_params``)."""
    if p["table"].dtype == torch.float32:
        return p
    return {**p, "table_f32": p["table"].float()}


def embed(p, tokens):
    """Rows of the table. An id outside [0, vocab) embeds as NaN, as JAX's
    ``jnp.take`` fills it: a corrupted token poisons its own row's logits
    (which the serving output guard then fails) instead of faulting the
    card with an out-of-range gather."""
    table = p["table"]
    ok = (tokens >= 0) & (tokens < table.shape[0])
    x = table[torch.where(ok, tokens, torch.zeros_like(tokens))]
    return x.masked_fill(~ok[..., None], float("nan"))


def unembed(p, x):
    """Tied unembedding: project hidden states to vocab logits (fp32).
    Serving reads the fp32 copy where there is one; a table that takes a
    gradient (grad mode on, ``requires_grad``) is read itself, so the
    logits' gradient reaches the table, as in JAX."""
    table = p["table"]
    if not (torch.is_grad_enabled() and table.requires_grad):
        table = p.get("table_f32", table)
    return x.float() @ table.float().T


# --------------------------------------------------------------------- remat
# "dots": the products without batch dims (JAX's
# dots_with_no_batch_dims_saveable): x @ w of a linear layer is aten.mm
_DOTS = ("mm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    name = getattr(op, "__name__", "").split(".")[0]
    return (CheckpointPolicy.MUST_SAVE if name in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, cfg):
    """``fn`` activation-checkpointed as JAX's ``remat_wrap``: "full"
    recomputes everything in the backward pass
    (``torch.utils.checkpoint.checkpoint``, non-reentrant); "dots" saves
    the matmul outputs and recomputes the rest (a selective checkpoint).
    Outside grad mode ``fn`` runs as it is: nothing would be recomputed."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be 'full' or 'dots', "
                         f"got {cfg.remat_policy!r}")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def maybe_remat(fn, cfg):
    """``remat_wrap(fn, cfg)`` when ``cfg.remat`` is on, else ``fn``."""
    return remat_wrap(fn, cfg) if cfg.remat else fn
