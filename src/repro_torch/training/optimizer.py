"""AdamW and Adafactor with JAX's schedule (port of
``repro/training/optimizer.py``).

The arithmetic is JAX's, computed over JAX's leaves. JAX stacks each layer
param over the layers ([L, ...]); the port keeps one tensor per layer
(``bridge``). Both rules read the stacked shape:

  * AdamW decays a leaf of rank >= 2. A stacked norm scale [L, D] is rank
    2, so JAX decays it (its comment says norms are exempt; the rank test
    says otherwise), and so does the port: a group's rank is its JAX rank,
    the per-layer rank + 1.
  * Adafactor factors the last two axes of the stacked leaf: a norm stack
    [L, D] keeps a row statistic over D per layer and a column statistic
    over the layers, and the RMS clip ``mean(u * u)`` is taken over the
    whole stack. The port stacks each group (``torch.stack``), updates it
    as JAX does and writes the layers back.

``layout(model_cfg, params)`` says which of the port's tensors form one
JAX leaf (the grouping ``bridge`` inverts: the dense, SSM and VLM
``layers``, the MoE ``dense{j}``/``moe`` interleave, the hybrid units of
each pattern slot plus the unstacked ``tail``, the encoder-decoder's
``enc_layers``/``dec_layers``). ``apply`` and the Adafactor functions take
it, where JAX reads the stack from the tree itself. The serving copy of a
tied table (``table_f32``) is no param: it is in no group.

AdamW updates its moments in place (the old state is consumed, as JAX's
train step donates it): at Llama 3.2 3B the fp32 moments are 25.7 GB, and
a second copy would not fit beside the params and gradients. The params
come back as new tensors. The step count is a host integer, so the
schedule reads no device value.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

Path = Tuple


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: int
    mu: object
    nu: object


# ---------------------------------------------------------------- the layout
class Group(NamedTuple):
    """One JAX leaf: the port tensors at ``paths`` (one per layer, in layer
    order, when ``stacked``; else a single tensor)."""
    name: str
    paths: List[Path]
    stacked: bool


def _unit(cfg, key, i) -> Tuple[str, bool]:
    """The JAX stack (name, stacked) that entry ``i`` of the list
    ``params[key]`` belongs to."""
    if key == "layers" and cfg.family == "moe":
        m = max(cfg.moe_every, 1)
        j = i % m
        return f"layers/{'moe' if j == m - 1 else f'dense{j}'}", True
    if key == "layers" and cfg.family == "hybrid":
        from repro_torch.models import hybrid
        n_blocks, pat, _ = hybrid.layout(cfg)
        if i < n_blocks * len(pat):
            j = i % len(pat)
            return f"blocks/u{j}_{pat[j]}", True
        return f"tail/{i - n_blocks * len(pat)}", False
    return key, True


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "table_f32":
                yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def layout(model_cfg, params) -> List[Group]:
    """The JAX leaves of ``params`` (a tree of ``model_cfg``'s family), in
    a fixed order."""
    groups: Dict[str, Group] = {}
    for key, sub in params.items():
        if isinstance(sub, list):
            for i, layer in enumerate(sub):
                unit, stacked = _unit(model_cfg, key, i)
                for path, _ in leaves(layer, (key, i)):
                    name = "/".join([unit] + [str(p) for p in path[2:]])
                    groups.setdefault(name, Group(name, [], stacked)).paths.append(path)
        else:
            for path, _ in leaves(sub, (key,)):
                name = "/".join(map(str, path))
                groups[name] = Group(name, [path], False)
    return list(groups.values())


def get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def replace_leaves(tree, values: Dict[Path, torch.Tensor], path=()):
    """``tree`` with the leaves at the paths of ``values`` replaced (new
    containers; leaves not named are shared; ``table_f32`` dropped)."""
    if isinstance(tree, dict):
        return {k: replace_leaves(v, values, path + (k,)) for k, v in tree.items()
                if k != "table_f32"}
    if isinstance(tree, (list, tuple)):
        return [replace_leaves(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values.get(path, tree)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items() if k != "table_f32"}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _rank(group: Group, t: torch.Tensor) -> int:
    return t.ndim + (1 if group.stacked else 0)


# -------------------------------------------------------------- the schedule
def _f32(x):
    return np.float32(x)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup -> cosine decay to min_lr_ratio, in fp32 as JAX
    computes it."""
    step = _f32(step)
    warm = step / _f32(max(cfg.warmup_steps, 1))
    prog = np.clip((step - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))
    cos = _f32(cfg.min_lr_ratio) + _f32(1 - cfg.min_lr_ratio) * _f32(0.5) \
        * (_f32(1) + np.cos(_f32(math.pi) * prog, dtype=np.float32))
    return float(_f32(cfg.lr) * (warm if step < cfg.warmup_steps else cos))


# ------------------------------------------------------------------- AdamW
def init(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    return OptState(0, zeros, tree_map(torch.zeros_like, zeros))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-dim tensor on
    the leaves' device)."""
    total = None
    for _, x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: OptState, lay: List[Group]):
    """Returns (new_params, new_state, metrics). ``state``'s moments are
    updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = float(1 - _f32(cfg.b1) ** _f32(step))
    bc2 = float(1 - _f32(cfg.b2) ** _f32(step))

    new = {}
    for group in lay:
        for path in group.paths:
            p, g = get(params, path), get(grads, path)
            m, n = get(state.mu, path), get(state.nu, path)
            g = g.float() * clip
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            n.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(n / bc2) + cfg.eps)
            if _rank(group, p) >= 2:   # JAX's rank: stacked norms decay too
                delta = delta + cfg.weight_decay * p.float()
            new[path] = (p.float() - lr * delta).to(p.dtype)
    return (replace_leaves(params, new), OptState(step, state.mu, state.nu),
            {"grad_norm": gnorm, "lr": lr})


# =========================================================== Adafactor
# Factored second moments (Shazeer & Stern, 2018): O(n+m) optimizer state
# per n x m matrix instead of AdamW's two fp32 copies.


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay_pow: float = 0.8          # beta2_t = 1 - t^-decay_pow
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_rms: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class FactoredState(NamedTuple):
    """Statistics per JAX leaf (keyed by the group's name), in JAX's
    shapes: vr [..., n] and vc [..., m] for a leaf of rank >= 2 (a dummy
    (1,) otherwise), v the full statistic for rank < 2 (a dummy otherwise)."""
    step: int
    vr: Dict[str, torch.Tensor]
    vc: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _stack(tree, group: Group) -> torch.Tensor:
    ts = [get(tree, p) for p in group.paths]
    return torch.stack(ts) if group.stacked else ts[0]


def init_adafactor(params, lay: List[Group]) -> FactoredState:
    vr, vc, v = {}, {}, {}
    for group in lay:
        p = get(params, group.paths[0])
        shape = ((len(group.paths),) if group.stacked else ()) + tuple(p.shape)
        z = lambda s: torch.zeros(s, dtype=torch.float32, device=p.device)
        factored = len(shape) >= 2
        vr[group.name] = z(shape[:-1]) if factored else z((1,))
        vc[group.name] = z(shape[:-2] + shape[-1:]) if factored else z((1,))
        v[group.name] = z((1,)) if factored else z(shape)
    return FactoredState(0, vr, vc, v)


@torch.no_grad()
def apply_adafactor(cfg: AdafactorConfig, params, grads, state: FactoredState,
                    lay: List[Group]):
    step = state.step + 1
    t = _f32(step)
    beta2 = float(_f32(1.0) - t ** _f32(-cfg.decay_pow))
    lr = schedule(AdamWConfig(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                              total_steps=cfg.total_steps,
                              min_lr_ratio=cfg.min_lr_ratio), step)
    scale = lr * max(cfg.eps2, 1.0)
    new, vrs, vcs, vs = {}, {}, {}, {}
    for group in lay:
        p = _stack(params, group)
        g = _stack(grads, group).float()
        vr, vc, v = (state.vr[group.name], state.vc[group.name],
                     state.v[group.name])
        g2 = g * g + cfg.eps1
        if p.ndim >= 2:
            vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=cfg.eps1)
            u = g * torch.rsqrt(torch.clamp(r[..., None], min=cfg.eps1)) \
                * torch.rsqrt(torch.clamp(vc[..., None, :], min=cfg.eps1))
        else:
            v = beta2 * v + (1 - beta2) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=cfg.eps1))
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)    # over the whole stack
        u = u / torch.clamp(rms / cfg.clip_rms, min=1.0)
        delta = u + cfg.weight_decay * p.float() if p.ndim >= 2 else u
        out = (p.float() - scale * delta).to(p.dtype)
        for path, layer in zip(group.paths, out.unbind(0) if group.stacked else [out]):
            new[path] = layer
        vrs[group.name], vcs[group.name], vs[group.name] = vr, vc, v
    return (replace_leaves(params, new), FactoredState(step, vrs, vcs, vs),
            {"grad_norm": global_norm(grads), "lr": lr})


# ----------------------------------------------------------- generic facade
def init_any(cfg, params, lay: List[Group]):
    return init_adafactor(params, lay) if isinstance(cfg, AdafactorConfig) \
        else init(params)


def apply_any(cfg, params, grads, state, lay: List[Group]):
    if isinstance(cfg, AdafactorConfig):
        return apply_adafactor(cfg, params, grads, state, lay)
    return apply(cfg, params, grads, state, lay)
