"""The train step: loss, microbatched gradient accumulation (port of
``repro/training/train_loop.py``).

``make_train_step(model, ocfg, num_microbatches)`` returns ``train_step(
params, opt_state, batch) -> (params, opt_state, metrics)`` as JAX's does;
PyTorch runs it eagerly, where JAX jits it. Gradients come from
``torch.autograd`` over the param tree (on the card the no-cache attention
differentiates through the flash kernels' ``FlashAttentionFn``). The tree a
step takes and returns holds no ``table_f32``: the tied unembedding reads
the table itself under grad (``models.layers.unembed``), and
``serving_params`` gives trained params their serving copy back.

JAX's ``opt_state_specs`` and ``shard_train_step`` (GSPMD shardings of the
step over a mesh) have no counterpart yet: sharding one model over several
cards waits for ROADMAP Queue 1's multi-device item.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.training import optimizer as opt

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


def cross_entropy(logits, labels):
    """logits fp32 [B, S, V]; labels int [B, S] -> mean nats/token. The gold
    logit is a gather, where JAX writes a masked sum over the vocab (a
    device for vocab-sharded logits under GSPMD); the value is the same."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(model, params, tokens, labels, extras=None):
    """(loss, metrics): the cross entropy, plus the MoE aux losses weighted
    as in JAX where the family returns them."""
    logits, _, aux = model.apply(params, tokens, **(extras or {}))
    loss = cross_entropy(logits.float(), labels)
    metrics = {"ce": loss}
    if aux and "load_balance" in aux:
        loss = loss + MOE_LB_COEF * aux["load_balance"] + MOE_Z_COEF * aux["router_z"]
        metrics.update(aux)
    return loss, metrics


def trainable(params):
    """The param tree a step takes: ``params`` without the serving copies of
    tied tables (``table_f32``), the leaves shared."""
    return opt.tree_map(lambda t: t, params)


def serving_params(params):
    """Trained params for serving: detached, with the fp32 copy of a tied
    bf16 table that the serving unembedding reads made afresh."""
    out = opt.tree_map(lambda t: t.detach(), params)
    if "lm_head" not in out and "table" in out.get("embed", {}):
        out["embed"] = L.with_f32_table(out["embed"])
    return out


def value_and_grad(model, params, tokens, labels, extras=None, lay=None):
    """(loss, metrics, grads): ``jax.value_and_grad`` of ``loss_fn`` over
    ``params`` (``table_f32`` left out), the grads a tree like it, each in
    its param's dtype; a param the loss does not reach gets zeros, as JAX
    gives."""
    params = trainable(params)
    lay = lay if lay is not None else opt.layout(model.cfg, params)
    paths = [p for g in lay for p in g.paths]
    leaves = {p: opt.get(params, p).detach().requires_grad_(True) for p in paths}
    with torch.enable_grad():
        loss, metrics = loss_fn(model, opt.replace_leaves(params, leaves), tokens,
                                labels, extras)
        gs = torch.autograd.grad(loss, [leaves[p] for p in paths],
                                 allow_unused=True)
    grads = opt.replace_leaves(params, {
        p: (torch.zeros_like(leaves[p]) if g is None else g)
        for p, g in zip(paths, gs)})
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, ocfg, num_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). batch: {"tokens": [B, S], "labels": [B, S]} (+ modality
    extras), tensors on the params' device. With num_microbatches > 1 the
    batch is split on axis 0 and fp32 gradients are summed microbatch by
    microbatch in order, then divided, as JAX's scan does; the metrics then
    carry only ``ce`` (the mean loss), as in JAX. A batch whose rows do not
    split evenly raises ``ValueError`` before any forward (JAX's reshape
    raises there too). ``opt_state`` comes from
    ``optimizer.init_any(ocfg, params, optimizer.layout(model.cfg,
    params))``."""
    lay_cache = {}

    def layout_of(params):
        if "lay" not in lay_cache:
            lay_cache["lay"] = opt.layout(model.cfg, trainable(params))
        return lay_cache["lay"]

    def train_step(params, opt_state, batch):
        params = trainable(params)
        lay = layout_of(params)
        tokens, labels = batch["tokens"], batch["labels"]
        extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        B = tokens.shape[0]
        if B % num_microbatches:
            raise ValueError(f"batch of {B} rows does not split into "
                             f"num_microbatches={num_microbatches} equal "
                             f"microbatches")
        if num_microbatches == 1:
            loss, metrics, grads = value_and_grad(model, params, tokens,
                                                  labels, extras, lay)
        else:
            mb = B // num_microbatches
            grads = opt.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(num_microbatches):
                sl = slice(i * mb, (i + 1) * mb)
                l_i, _, g_i = value_and_grad(
                    model, params, tokens[sl], labels[sl],
                    {k: v[sl] for k, v in extras.items()}, lay)
                for path, g in opt.leaves(g_i):
                    opt.get(grads, path).add_(g.float())
                loss = loss + l_i
            grads = opt.tree_map(lambda g: g / num_microbatches, grads)
            loss = loss / num_microbatches
            metrics = {"ce": loss}
        new_params, new_opt, om = opt.apply_any(ocfg, params, grads, opt_state, lay)
        return new_params, new_opt, dict(metrics, **om, loss=loss)

    return train_step


def init_opt_state(model, ocfg, params):
    """``optimizer.init_any`` over ``params``' layout."""
    params = trainable(params)
    return opt.init_any(ocfg, params, opt.layout(model.cfg, params))
