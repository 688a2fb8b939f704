"""Mixture-of-Experts transformer, Mixtral / Llama-4 style (port of
``repro/models/moe.py``).

A block is ``moe_every - 1`` dense layers and then one MoE layer, and the
model runs ``num_layers // moe_every`` blocks (JAX's count: a remainder of
layers is dropped, and a config with fewer layers than ``moe_every`` has
no block at all). JAX stacks each block kind on axis 0 (``dense{j}`` and
``moe``); here ``params["layers"]`` is the flat list of those layers in
forward order: layer ``i * moe_every + j`` is JAX's ``dense{j}[i]`` for
j < moe_every - 1 and its ``moe[i]`` for the last j. The KV caches take
the dense family's layout, one [L, ...] K and one V buffer per role in the
same order, where JAX nests its cache by block kind; for Mixtral
(``moe_every`` 1) the two layouts hold the same leaves. Attention is the
dense family's (``dense.attn_block``), so paged caches, rings and windowed
rings that wrap carry over; tree-verify passes stay dense-only, as in JAX.

Routing (``moe_mlp``) is JAX's exactly: fp32 router logits, softmax, the
top k by a stable descending sort (``jax.lax.top_k`` puts the lower expert
first on ties; ``torch.topk`` promises no order), renormalised by their sum
with a 1e-9 floor. Tokens are flattened row-major and grouped
(``group_shape``); routing is dropless while g * K <= 512, else each expert
takes ``cap = max(1, int(g * K / E * 1.25))`` (token, choice) pairs per
group, in token order then choice order, and a pair at or past ``cap`` is
dropped, its gate not renormalised.

Dispatch differs from JAX's capacity buffers ([G, E, C, D] one-hot
einsums): every expert runs on every token of the call and the combine
weights each output by its gate, which is zero for a pair that was not
routed or was dropped. Per token that is JAX's arithmetic (its buffer rows
are exact copies of the token, and zero rows add nothing), with JAX's
FLOPs whenever it is dropless (cap = g), and it reads nothing on the host,
so a round stays free of syncs. The routed experts bypass
``layers.linear``: int8 serving weights are dequantized in the activation
dtype (``w_q * scale``, as JAX does) and ``quant.int8.act_quant`` does not
touch them. The router and the shared expert go through
``layers.linear`` and are act-quantized (the int8 path under
``act_quant``). ``moe_mlp`` returns the load-balance and router-z aux
losses; ``forward`` averages them over the blocks.

API:
  init(cfg, gen, device)                           -> params
  forward(cfg, params, tokens, cache, ...)          -> logits, new_cache, aux
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import dense
from repro_torch.models import layers as L


# ---------------------------------------------------------------------- layout
def block_size(cfg) -> int:
    """Layers per block: ``moe_every`` (at least 1)."""
    return max(cfg.moe_every, 1)


def n_blocks(cfg) -> int:
    return cfg.num_layers // block_size(cfg)


def n_layers(cfg) -> int:
    """Layers the forward runs (and cache buffers hold): whole blocks."""
    return n_blocks(cfg) * block_size(cfg)


# ---------------------------------------------------------------------- init
def _stacked_linear(gen, E, d_in, d_out, dtype, device):
    return {"w": torch.stack([L.init_linear(gen, d_in, d_out, dtype, device)["w"]
                              for _ in range(E)])}


def init_moe_mlp(gen, cfg, device):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = cfg.weight_dtype
    p = {"router": L.init_linear(gen, d, E, dt, device, scale=d ** -0.5),
         "experts": {"gate": _stacked_linear(gen, E, d, f, dt, device),
                     "up": _stacked_linear(gen, E, d, f, dt, device),
                     "down": _stacked_linear(gen, E, f, d, dt, device)}}
    if cfg.num_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, cfg.num_shared_experts * f, dt,
                                    device)
    return p


def init_layer(gen, cfg, device):
    return {"attn": dense.init_attn(gen, cfg, device),
            "mlp_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
            "moe": init_moe_mlp(gen, cfg, device)}


def init(cfg, gen: torch.Generator, device, layer_fn=None):
    """Seeded random weights, the layers in forward order (a block's dense
    layers, then its MoE layer). ``layer_fn`` maps each layer's params as
    it is made, before the next is (``quant.int8.init_for_serving``
    quantizes there, so a model whose float weights exceed the card never
    holds them all at once)."""
    layer_fn = layer_fn or (lambda lp: lp)
    m = block_size(cfg)
    params = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                        cfg.weight_dtype, device,
                                        scale=cfg.embed_init_scale),
              "final_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype,
                                           device)}
    if cfg.tie_embeddings:
        params["embed"] = L.with_f32_table(params["embed"])
    else:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                          cfg.weight_dtype, device)
    params["layers"] = [
        layer_fn(init_layer(gen, cfg, device) if l % m == m - 1
                 else dense.init_layer(gen, cfg, device))
        for l in range(n_layers(cfg))]
    return params


# ------------------------------------------------------------------- routing
def group_shape(T: int) -> int:
    """Tokens per routing group. Groups bound the capacity buffer size."""
    for g in (2048, 1024, 512, 256, 128):
        if T % g == 0:
            return g
    return T


def capacity(cfg, g: int) -> int:
    """(token, choice) pairs an expert takes per group of g tokens: all of
    them while g * K <= 512 (serving's dropless regime), else capacity
    factor 1.25."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    if g * K <= 512:
        return g
    return max(1, int(g * K / E * 1.25))


def top_k(probs, k):
    """The k largest along the last axis, largest first and the lower index
    first among ties (``jax.lax.top_k``'s order): (values, int64 indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, p, xt):
    """Router of one layer over grouped tokens xt [G, g, D]: fp32 logits and
    probabilities [G, g, E], the renormalised top-k gates [G, g, K] and
    their experts [G, g, K]."""
    logits = L.linear(p["router"], xt).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, cfg.num_experts_per_tok)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return logits, probs, top_p, top_e


def dispatch(top_e, E, cap):
    """Which (token, choice) pairs their expert takes: bool [G, g, K, E],
    true where the pair goes to that expert within its capacity. A pair's
    slot counts the pairs of its group ahead of it for the same expert,
    in token order, then choice order."""
    G, g, K = top_e.shape
    assign = F.one_hot(top_e, E).to(torch.int32)              # [G, g, K, E]
    flat = assign.reshape(G, g * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, K, E)
    return (pos < cap) & (assign > 0)


def expert_weight(wd, dtype):
    """A stacked expert weight [E, K, N] in ``dtype``: int8 serving weights
    dequantized as JAX does (``w_q * scale[:, None, :]`` in ``dtype``). The
    int8 operand is promoted inside the multiply, one pass over the
    weights where a cast first would be two; the bits are the same (an
    int8 value is exact in ``dtype``, and the product is rounded once)."""
    if "w_q" in wd:
        return wd["w_q"] * wd["scale"][:, None, :].to(dtype)
    return wd["w"].to(dtype)


def moe_mlp(cfg, p, x):
    """x: [B, S, D] -> (y, aux losses). Routes over the flattened B*S tokens
    (module docstring)."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    g = group_shape(T)
    xt = x.reshape(T // g, g, D)
    logits, probs, top_p, top_e = route(cfg, p, xt)
    within = dispatch(top_e, E, capacity(cfg, g))
    # a token takes each expert at most once: one nonzero term per sum
    gate = (top_p[..., None] * within).sum(2).reshape(T, E)   # fp32

    xf = x.reshape(T, D)
    w = p["experts"]
    xe = xf.expand(E, T, D)
    h = F.silu(torch.matmul(xe, expert_weight(w["gate"], x.dtype)))
    h = h * torch.matmul(xe, expert_weight(w["up"], x.dtype))
    ye = torch.matmul(h, expert_weight(w["down"], x.dtype))   # [E, T, D]
    y = torch.einsum("te,etd->td", gate.to(x.dtype).float(), ye.float())
    y = y.to(x.dtype).reshape(B, S, D)

    if cfg.num_shared_experts:
        y = y + L.swiglu(p["shared"], x)

    # aux: load-balance (Switch) + router z-loss, before any drop
    assign = F.one_hot(top_e, E).float()                       # [G, g, K, E]
    density = assign.sum(2).mean(1)                            # [G, E]
    lb = (density * probs.mean(1)).sum(-1).mean() * E
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"load_balance": lb, "router_z": z}


def moe_layer(cfg, p, x, lc, ps: "dense.Pass"):
    x = x + dense.attn_block(cfg, p["attn"], x, ps.q_pos, lc, ps.index,
                             cfg.sliding_window, ps.block_table, ps.max_live,
                             None, ps.ring)
    y, aux = moe_mlp(cfg, p["moe"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
    return x + y, aux


def forward(cfg, params, tokens, cache, *, logits_slice=None, max_live=None):
    """As ``dense.forward`` (no tree passes), over the blocks' layers; also
    returns the aux losses averaged over the blocks (NaN with none, as in
    JAX)."""
    x, ps = dense.begin(cfg, params, tokens, cache, cfg.sliding_window,
                        max_live)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    rz = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, lp in enumerate(params["layers"]):
        layer = moe_layer if "moe" in lp else dense.run_layer
        if cache is None:     # checkpointed under cfg.remat, as JAX's scan
            out = L.maybe_remat(
                lambda h, lp=lp, f=layer: f(cfg, lp, h, None, ps), cfg)(x)
        else:
            out = layer(cfg, lp, x, dense.layer_cache(cache, l), ps)
        if "moe" in lp:
            x, aux = out
            lb = lb + aux["load_balance"]
            rz = rz + aux["router_z"]
        else:
            x = out
    logits, new_cache = dense.end(cfg, params, x, cache, logits_slice)
    nb = n_blocks(cfg)
    aux = {"load_balance": lb / nb if nb else lb * float("nan"),
           "router_z": rz / nb if nb else rz * float("nan")}
    return logits, new_cache, aux
