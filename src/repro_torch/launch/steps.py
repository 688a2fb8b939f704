"""Step builders (port of ``repro/launch/steps.py``, one device).

Each builder returns ``(step_fn, inputs)``. ``step_fn`` is the step as a
plain function (PyTorch runs it eagerly where JAX jits it), and
``inputs`` is JAX's dict of its arguments (``params``, ``opt_state``,
``batch``, ``tokens``, ``cache``, ``extras``, ``params_t``, ``params_d``,
``t_last``, ``tcache``, ``dcache``) with ``meta`` tensors for leaves, the
port's ``ShapeDtypeStruct``: every shape and dtype, no memory. The dry run
(``launch.dryrun``) reads them; a caller that runs a step makes tensors
like them on its device.

What the steps compute is JAX's: the train step is
``train_loop.make_train_step``; prefill and decode are ``Model.apply(...,
logits_slice="last")`` on a fresh cache (decode: one token against a
cache of ``shape.seq_len``; the encoder-decoder's takes the cross K/V as
an input); the spec round is one cached ``batch_min`` greedy round
through ``rounds.draft_phase``/``verify_phase``, whose minimum commit
rolls both caches back through ``cache.ops.ops_for``.

Deliberate differences from JAX's builders:

  * No ``mesh`` or ``ShardingPolicy`` argument: a step runs on one device
    and nothing is sharded. ``extras_specs`` (and ``models/specs.py``'s
    ``ns_tree``/``sds_with``) stay unported with the spec-tree builders.
  * The caches are updated in place where JAX donates them.
  * The params are the tree without the serving copy of a tied table
    (``table_f32``, a derived cache ``layers.unembed`` does without), so
    a step's arguments hold JAX's leaves only; the optimizer's step count
    is a host int (``training.optimizer``).
  * The cache layout is the port's (``Model.cache_spec``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.cache import ops as cache_ops
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import rounds
from repro_torch.models.model import Model
from repro_torch.quant import int8
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def params_shape(model: Model, quantized: bool = False):
    """The params' shapes: ``model.init`` on the meta device, or (``quantized``)
    ``quant.int8.init_for_serving``'s int8 serving tree; without
    ``table_f32``."""
    if quantized:
        return train_loop.trainable(int8.init_for_serving(model, 0, META))
    return train_loop.trainable(model.init(0, META))


def extras_shape(model: Model, batch: int) -> dict:
    """The modality stand-ins (``Model.extra_inputs``) as meta tensors."""
    return {k: _meta(shape, dtype)
            for k, (shape, dtype) in model.extra_inputs(batch).items()}


# ---------------------------------------------------------------------- train
def build_train_step(model: Model, shape: ShapeConfig, num_microbatches: int = 1,
                     ocfg: Optional[opt.AdamWConfig] = None):
    ocfg = ocfg or opt.AdamWConfig()
    B, S = shape.global_batch, shape.seq_len
    pshape = params_shape(model)
    bshape = {"tokens": _meta((B, S), torch.int32),
              "labels": _meta((B, S), torch.int32),
              **extras_shape(model, B)}
    inputs = {"params": pshape,
              "opt_state": train_loop.init_opt_state(model, ocfg, pshape),
              "batch": bshape}
    return train_loop.make_train_step(model, ocfg, num_microbatches), inputs


# -------------------------------------------------------------------- prefill
def build_prefill_step(model: Model, shape: ShapeConfig, quantized: bool = False,
                       cache_int8: bool = False):
    """Full-sequence forward populating a fresh KV/state cache."""
    B, S = shape.global_batch, shape.seq_len
    cdtype = torch.int8 if cache_int8 else None

    def prefill(params, tokens, cache, extras):
        logits, new_cache, _ = model.apply(params, tokens, cache,
                                           logits_slice="last", **extras)
        return logits, new_cache

    inputs = {"params": params_shape(model, quantized),
              "tokens": _meta((B, S), torch.int32),
              "cache": model.cache_spec(B, S, spec_slack=0, dtype=cdtype),
              "extras": extras_shape(model, B)}
    return prefill, inputs


# --------------------------------------------------------------------- decode
def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return shape.seq_len


def build_decode_step(model: Model, shape: ShapeConfig, quantized: bool = False,
                      cache_int8: bool = False):
    """serve_step: ONE new token against a cache of shape.seq_len."""
    B = shape.global_batch
    S = decode_cache_len(model.cfg, shape)
    cdtype = torch.int8 if cache_int8 else None
    extras = {}
    if model.family == "encdec":
        # the encoder-decoder's decode takes the (static) cross K/V
        cfg = model.cfg
        kv = (cfg.num_layers, B, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        extras["cross"] = {"k": _meta(kv, cfg.act_dtype),
                           "v": _meta(kv, cfg.act_dtype)}

    def decode(params, tokens, cache, extras):
        logits, new_cache, _ = model.apply(params, tokens, cache,
                                           logits_slice="last", **extras)
        return logits, new_cache

    inputs = {"params": params_shape(model, quantized),
              "tokens": _meta((B, 1), torch.int32),
              "cache": model.cache_spec(B, S, spec_slack=0, dtype=cdtype),
              "extras": extras}
    return decode, inputs


# ----------------------------------------------------- speculative serve step
def build_spec_round_step(target: Model, drafter: Model, shape: ShapeConfig,
                          gamma: int = 4):
    """One speculative round (gamma cached draft steps, one verify pass,
    greedy acceptance, the batch-minimum commit and both rollbacks) from a
    state whose visible buffer is the last committed token ``t_last``.
    Returns (out_tokens [B, gamma + 1], n_commit, tcache, dcache)."""
    B = shape.global_batch
    S = decode_cache_len(target.cfg, shape)
    spec = rounds.RoundSpec(gamma=gamma, greedy=True, commit="batch_min",
                            use_cache=True)

    def spec_round(params_t, params_d, t_last, tcache, dcache):
        state = rounds.RoundState(
            tokens=t_last[:, None],
            length=torch.ones((), dtype=torch.int32, device=t_last.device),
            dcache=dcache, tcache=tcache)
        d = rounds.draft_phase(drafter, params_d, state, spec)
        v = rounds.verify_phase(target, params_t, state, d, spec)
        n_commit = torch.min(v.res.n_emitted)
        new_index = v.tcache["index"] - (gamma + 1) + n_commit
        tcache = cache_ops.ops_for(v.tcache).rollback(v.tcache, new_index)
        dcache = cache_ops.ops_for(d.dcache).rollback(d.dcache, new_index)
        return v.res.out_tokens, n_commit, tcache, dcache

    inputs = {"params_t": params_shape(target),
              "params_d": params_shape(drafter),
              "t_last": _meta((B,), torch.int32),
              "tcache": target.cache_spec(B, S, spec_slack=gamma + 2),
              "dcache": drafter.cache_spec(B, S, spec_slack=gamma + 2)}
    return spec_round, inputs
