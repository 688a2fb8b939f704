"""Tensor parallelism of one dense-family role over its model axis.

Single-controller PyTorch: one process holds, for every leaf, one tensor
per device of the role's model axis (``parallel.shards.Shards``), and runs
each device's share of a forward in turn; nothing uses
``torch.distributed``. The layout is JAX's ``param_specs`` one
(``models/specs.py``), megatron style:

  * column-parallel q/k/v/gate/up (output dim split), row-parallel o/down
    (input dim split) followed by ``all_reduce_sum``;
  * the residual stream is replicated, and every device runs the norms;
  * embedding and unembedding vocab-parallel when the model axis divides
    the vocabulary: each device looks up the ids of its rows (others give
    0) and an ``all_reduce_sum`` follows; an id outside [0, vocab) then
    embeds as NaN, as ``layers.embed`` gives it; each device's logits are
    its vocabulary slice, and ``all_gather`` brings them to the role's
    first device (``io_specs``' logits spec, (batch, None, model));
  * a d_ff or vocabulary the axis does not divide is replicated (as the
    spec gives it): every device computes the whole MLP or unembedding and
    nothing is reduced.

Attention runs per device over the KV heads it holds, through the same
``dense.attn_block`` and kernels as the unsharded forward with local head
counts (H/n query heads; the GQA group size is unchanged). When n divides
Kv each device holds Kv/n KV heads. When n does not divide Kv but divides
H and is a multiple of Kv, each device holds one KV head, the one its H/n
query heads read, so the k/v weights and the cache of that head are
replicated over n/Kv devices (each copy written by its own device). JAX's
``param_specs`` instead splits a KV head's columns across devices and lets
GSPMD resolve it (ROADMAP.md, deliberate differences). Any other n raises.

The cache is one cache per device holding that device's KV heads
(``k``/``v`` are ``Shards``); ``index``, ``positions`` and the block table
are shared and live on the role's first device. JAX's ``cache_specs``
shards the ring's sequence axis instead (a deliberate difference; the
per-device bytes are equal when both divide).

``all_reduce_sum`` copies every partial to each device and adds them in
shard order in fp32, rounding once to the partials' dtype, so the result
does not depend on which device adds. Devices that repeat in the list (a
role lowered over one card's entries) share one result.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.specs import axis_names, leaf_plan, zip_with_path
from repro_torch.parallel.shards import Shards, is_sharded_cache
from repro_torch.quant import int8 as q8


# ------------------------------------------------------------------- layout
@dataclass(frozen=True)
class TPLayout:
    """How one role's dense model splits over the ``n`` devices of its
    model axis (shard order)."""
    name: str
    cfg: object
    devices: tuple
    positions: tuple
    heads: int              # query heads per device
    kv_heads: int           # KV heads per device
    kv_copies: int          # devices holding each KV head (1: split)
    vocab_sharded: bool
    mlp_sharded: bool

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def local_cfg(self):
        """The config one device's attention runs with."""
        return self.cfg.replace(num_heads=self.heads, num_kv_heads=self.kv_heads)

    def kv_head(self, i: int) -> int:
        """The first KV head device ``i`` holds."""
        if self.kv_copies > 1:
            group = self.cfg.num_heads // self.cfg.num_kv_heads
            return (i * self.heads) // group
        return i * self.kv_heads

    def describe(self) -> str:
        kv = (f"KV replicated over {self.kv_copies}" if self.kv_copies > 1
              else "KV split")
        return (f"{self.name} {self.cfg.name} tensor-parallel over {self.n}: "
                f"{self.heads} q / {self.kv_heads} KV heads a device, {kv}, "
                f"vocab {'split' if self.vocab_sharded else 'replicated'}, "
                f"mlp {'split' if self.mlp_sharded else 'replicated'}")


def make_layout(cfg, name, devices, positions) -> TPLayout:
    """The layout of a dense ``cfg`` over ``devices``; raises ValueError
    when the heads cannot be split (n must divide H, and divide Kv or be a
    multiple of it)."""
    n, H, Kv = len(devices), cfg.num_heads, cfg.num_kv_heads
    if cfg.family != "dense":
        raise ValueError(f"tensor parallelism takes the dense family, "
                         f"got {cfg.family!r}")
    if H % n == 0 and Kv % n == 0:
        kv_heads, copies = Kv // n, 1
    elif H % n == 0 and n % Kv == 0:
        kv_heads, copies = 1, n // Kv
    else:
        raise ValueError(f"{name}: {n} devices cannot split {H} query heads "
                         f"and {Kv} KV heads (n must divide H, and divide Kv "
                         f"or be a multiple of it)")
    return TPLayout(name, cfg, tuple(devices), tuple(positions), H // n,
                    kv_heads, copies, cfg.vocab_size % n == 0,
                    cfg.d_ff % n == 0)


class TPParams(dict):
    """A role's params split over its model axis: the param tree with
    ``Shards`` leaves, its ``layout``, and ``local[i]``, the plain tree of
    device i's pieces that its share of a forward reads."""

    def __init__(self, tree, layout: TPLayout):
        super().__init__(tree)
        self.layout = layout
        self.local = [_pick(tree, i) for i in range(layout.n)]


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree.parts[i]


def layout_of(params) -> Optional[TPLayout]:
    """The layout of a sharded params record, else None."""
    return params.layout if isinstance(params, TPParams) else None


# -------------------------------------------------------------- params
_KV = ("attn/k/", "attn/v/")


def _copy(piece, dev):
    """A contiguous copy of ``piece`` on ``dev``, never a view: a split is
    a snapshot of its source, whatever device either lives on."""
    return piece.to(dev, copy=True, memory_format=torch.contiguous_format)


def shard_params(params, layout: TPLayout, specs, policy) -> TPParams:
    """``params`` (the whole tree, on any device) split onto
    ``layout.devices`` by ``specs`` (``param_specs`` over the role's
    ``policy``): each leaf's pieces are copies of the slices
    ``specs.leaf_plan`` gives the devices of the model axis (a replicated
    leaf's too, so no piece aliases ``params``); the k/v weights of a
    replicated KV head take that head's columns instead. Raises ValueError
    on a spec the layout cannot take (a data axis, an attention weight the
    spec leaves whole)."""
    lay, hd = layout, layout.cfg.head_dim
    axes = axis_names(policy.model)
    sizes = tuple(policy.mesh_axis_sizes[a] for a in axes)

    def one(path, spec, leaf):
        devs = lay.devices
        if lay.kv_copies > 1 and any(k in path + "/" for k in _KV):
            cols = [slice(lay.kv_head(i) * hd, (lay.kv_head(i) + 1) * hd)
                    for i in range(lay.n)]
            return Shards(tuple(_copy(leaf[..., c], d)
                                for c, d in zip(cols, devs)), "kv_heads")
        dims = [d for d, e in enumerate(spec) if e is not None]
        if any(spec[d] != policy.model for d in dims):
            raise ValueError(f"{path}: spec {spec} names axes other than the "
                             f"model axis {policy.model!r}")
        if not dims and any(path.endswith(f"attn/{w}/{x}")
                            for w in "qo" for x in ("w", "w_q")):
            raise ValueError(f"{path}: the spec leaves an attention weight "
                             "whole")
        plan = leaf_plan(spec, tuple(leaf.shape), axes, sizes)
        return Shards(tuple(_copy(leaf[sl], d)
                            for sl, d in zip(plan.slices, devs)),
                      dims[0] if dims else None)

    tree = zip_with_path(one, specs, params)
    want = {"vocab": lay.vocab_sharded, "mlp": lay.mlp_sharded}
    got = {"vocab": tree["embed"]["table"].dim is not None,
           "mlp": tree["layers"][0]["mlp"]["down"][
               "w_q" if "w_q" in tree["layers"][0]["mlp"]["down"] else "w"].dim
           is not None}
    if got != want:
        raise ValueError(f"specs split {got}, the layout expects {want}")
    return TPParams(tree, lay)


# -------------------------------------------------------------- caches
def init_cache(make, layout: TPLayout):
    """A sharded cache from ``make(kv_heads, device)``, which builds one
    device's cache: ``k``/``v`` pieces from each device's, every other
    leaf from the first device's."""
    per = [make(layout.kv_heads, d) for d in layout.devices]
    return {**per[0], "k": Shards(tuple(c["k"] for c in per), 3),
            "v": Shards(tuple(c["v"] for c in per), 3)}


def place_cache(cache, layout: TPLayout):
    """A cache made split by ``layout`` (``init_cache``), its shared leaves
    (index, positions, block table) moved to the first device. Raises
    ValueError for any other cache: a whole cache is never split here, so
    that no role's prefill or pool runs unsplit first."""
    if cache is None:
        return None
    if not is_sharded_cache(cache):
        raise ValueError(f"{layout.name}: a tensor-parallel role's cache is "
                         "made split (init_cache/init_paged_cache with "
                         "layout=), not split afterwards")
    devs = tuple(p.device for p in cache["k"].parts)
    heads = {p.shape[3] for name in ("k", "v") for p in cache[name].parts}
    if devs != layout.devices or heads != {layout.kv_heads}:
        raise ValueError(f"{layout.name}: cache of {len(devs)} shards with "
                         f"{sorted(heads)} KV heads, layout of {layout.n} "
                         f"with {layout.kv_heads}")
    first = layout.devices[0]
    return {k: (v.to(first) if isinstance(v, torch.Tensor) else v)
            for k, v in cache.items()}


# ---------------------------------------------------------- collectives
def all_reduce_sum(pieces, devices, dtype=None):
    """Each device's copy of the sum of ``pieces`` (one per device, shard
    order): added in shard order in fp32 and rounded once to ``dtype``
    (default the pieces'). A device that repeats in ``devices`` shares
    its result."""
    dtype = dtype or pieces[0].dtype
    out = {}
    for dev in devices:
        if dev not in out:
            acc = pieces[0].to(dev, torch.float32)
            for p in pieces[1:]:
                acc = acc + p.to(dev, torch.float32)
            out[dev] = acc.to(dtype)
    return [out[d] for d in devices]


def all_gather(pieces, devices, dim=-1):
    """The pieces concatenated in shard order on the first device."""
    return torch.cat([p.to(devices[0]) for p in pieces], dim=dim)


# -------------------------------------------------------------- forward
def _pass_on(ps: dense.Pass, dev) -> dense.Pass:
    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple):
            return tuple(to(t) for t in x)
        return x
    return dense.Pass(*(to(f) for f in ps))


def _embed(cfg, lay: TPLayout, local, tokens):
    """The embedding on the first device, in the table's dtype."""
    if not lay.vocab_sharded:
        return L.embed(local[0]["embed"], tokens)
    rows = cfg.vocab_size // lay.n
    pieces = []
    for i, dev in enumerate(lay.devices):
        ids = tokens.to(dev) - i * rows
        ok = (ids >= 0) & (ids < rows)
        x = local[i]["embed"]["table"][torch.where(ok, ids, torch.zeros_like(ids))]
        pieces.append(x.masked_fill(~ok[..., None], 0))
    x = all_reduce_sum(pieces, lay.devices)[0]
    bad = (tokens < 0) | (tokens >= cfg.vocab_size)
    return x.masked_fill(bad[..., None], float("nan"))


def forward(cfg, params: TPParams, tokens, cache, *, logits_slice=None,
            max_live=None, tree=None):
    """``dense.forward`` of a sharded role: the same arguments and
    returns, the logits on the role's first device. ``cache`` must be
    sharded by the same layout (``init_cache``)."""
    lay, local = params.layout, params.local
    devs = lay.devices
    if cache is not None and not is_sharded_cache(cache):
        raise ValueError("a tensor-parallel forward needs a cache made "
                         "split by its layout (init_cache with layout=)")
    if cache is not None and len(cache["k"]) != lay.n:
        raise ValueError(f"cache of {len(cache['k'])} shards, layout of {lay.n}")
    if q8.act_scale_is_dynamic():
        raise NotImplementedError(
            "a tensor-parallel forward takes w8a8 only with a static "
            "activation scale (a row-parallel input's dynamic amax is "
            "per device)")
    # settle the read on the first device; shard 0's buffers give the
    # shapes every shard shares
    view = None if cache is None else {**cache, "k": cache["k"].parts[0],
                                      "v": cache["v"].parts[0]}
    x0, ps = dense.begin(cfg, None, None, view, cfg.sliding_window, max_live,
                         tree, input_embeds=_embed(cfg, lay, local, tokens))
    on = {}
    for d in devs:
        if d not in on:
            on[d] = (x0.to(d), _pass_on(ps, d))
    xs = [on[d][0] for d in devs]
    lcfg = lay.local_cfg

    def add(a, b):          # the replicated residual: once per device
        done = {}
        for i, d in enumerate(devs):
            if d not in done:
                done[d] = a[i] + b[i]
        return [done[d] for d in devs]

    for l in range(len(local[0]["layers"])):
        att = []
        for i, d in enumerate(devs):
            p, pd = local[i]["layers"][l], on[d][1]
            lc = None if cache is None else {"k": cache["k"].parts[i][l],
                                            "v": cache["v"].parts[i][l]}
            att.append(dense.attn_block(
                lcfg, p["attn"], xs[i], pd.q_pos, lc, pd.index,
                cfg.sliding_window, pd.block_table, pd.max_live, pd.tree,
                pd.ring))
        xs = add(xs, all_reduce_sum(att, devs))
        mlp = [L.swiglu(local[i]["layers"][l]["mlp"],
                        L.rmsnorm(local[i]["layers"][l]["mlp_norm"], xs[i],
                                  cfg.norm_eps))
               for i in range(lay.n)]
        xs = add(xs, all_reduce_sum(mlp, devs) if lay.mlp_sharded else mlp)
    if lay.vocab_sharded:
        logits = all_gather([dense.end(cfg, local[i], xs[i], None,
                                       logits_slice)[0]
                             for i in range(lay.n)], devs)
    else:
        logits = dense.end(cfg, local[0], xs[0], None, logits_slice)[0]
    if cache is None:
        return logits, None
    return logits, {**cache, "index": cache["index"] + x0.shape[1]}
