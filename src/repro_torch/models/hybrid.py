"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent units + local attention
(arXiv:2402.19427), pattern (rec, rec, attn) cycled (port of
``repro/models/hybrid.py``).

JAX splits the layer stack into full pattern blocks scanned with
``lax.scan`` (each unit kind stacked over the blocks) plus a tail of
leftover layers; here ``params["layers"]`` is the flat list of units in
forward order (block i's units, then the tail), ``kinds(cfg)`` names each
one's kind, and a Python loop runs them. A unit is ``{"mix", "mlp_norm",
"mlp"}``: ``mix`` is an RG-LRU layer (``rec``) or the dense family's
attention params (``attn``), windowed by ``cfg.local_window``.

RG-LRU recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t) with
a_t = exp(-c * softplus(lam) * r_t), in fp32 (``r``, ``i``, ``a`` and the
gated input). A single-token call takes JAX's fused step; a longer one a
log-step (Hillis-Steele) scan over (a, b) pairs where JAX runs
``lax.associative_scan``: ceil(log2 Q) rounds of two elementwise ops, each
position's result a function of its own prefix only (so the no-cache
buffer's rows do not change with T). Its fp32 association is not JAX's
(held at 1e-5).

The cache is flat, where JAX nests it by block and unit
(``{"blocks": {"u{i}_{kind}": ...}, "tail": [...]}``): one ``state``
[L_rec, B, W] and one ``conv`` [L_rec, B, 3, W] stack over the recurrent
units in forward order, both in the activation dtype as in JAX; one ring
``k``/``v`` [L_attn, B, W_ring, Kv, D] over the attention units (the dense
family's ring, read through the paged kernel, ``positions`` where it
wraps); and ``index``. So the stateful drafter's state snapshots
(``core.rounds._state_leaves``) and the dense ring read carry over, and a
verify's ``want_trail`` adds ``state_trail`` [L_rec, B, Q, W] and
``conv_trail`` [L_rec, B, Q, 3, W], from which ``rollback`` selects as the
ssm family's does. A cached forward returns new state/conv tensors and
writes the rings in place, as the ssm and dense families do.

API:
  init(cfg, gen, device)                                   -> params
  forward(cfg, params, tokens, cache=None, logits_slice=None,
          want_trail=False)                                -> logits, new_cache
  init_state(cfg, batch, dtype, device)                    -> state leaves
  rollback(cache, accepted_index, q_len)                   -> cache
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import dense, ssm
from repro_torch.models import layers as L

RGLRU_C = 8.0
TRAILS = ("state_trail", "conv_trail")


# -------------------------------------------------------------------- layout
def layout(cfg):
    """(n_blocks, pattern, tail kinds): full pattern blocks + leftover
    layers, as JAX splits them."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    n_blocks = cfg.num_layers // len(pat)
    tail = tuple(pat[i % len(pat)] for i in range(cfg.num_layers - n_blocks * len(pat)))
    return n_blocks, pat, tail


def kinds(cfg):
    """Each unit's kind in forward order."""
    n_blocks, pat, tail = layout(cfg)
    return tuple(pat) * n_blocks + tail


def n_attn(cfg) -> int:
    return kinds(cfg).count("attn")


# ---------------------------------------------------------------------- init
def _lam(w, device):
    """The fixed RG-LRU decay parameter, fp32 whatever the param dtype (as
    in JAX): a^c roughly uniform in (0.9, 0.999), griffin practice. On the
    CPU, so every device holds the same bits."""
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32)
    return torch.log(torch.expm1(-torch.log(lin) / RGLRU_C)).to(device)


def init_rec_layer(gen, cfg, device):
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = cfg.weight_dtype
    p = {"norm": L.init_rmsnorm(d, dt, device),
         "in_x": L.init_linear(gen, d, w, dt, device),
         "in_gate": L.init_linear(gen, d, w, dt, device)}
    conv_w = torch.randn((4, w), generator=gen, dtype=torch.float32, device=device)
    p["conv_w"] = (conv_w * 0.5).to(dt)
    p["conv_b"] = torch.zeros((w,), dtype=dt, device=device)
    p["gate_r"] = L.init_linear(gen, w, w, dt, device)
    p["gate_i"] = L.init_linear(gen, w, w, dt, device)
    p["lam"] = _lam(w, device)
    p["out"] = L.init_linear(gen, w, d, dt, device)
    return p


def init_unit(gen, cfg, kind, device):
    mix = (init_rec_layer(gen, cfg, device) if kind == "rec"
           else dense.init_attn(gen, cfg, device))
    return {"mix": mix,
            "mlp_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
            "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.weight_dtype,
                                 device)}


def init(cfg, gen: torch.Generator, device):
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.weight_dtype, device,
                                  scale=cfg.embed_init_scale),
        "layers": [init_unit(gen, cfg, kind, device) for kind in kinds(cfg)],
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
    }
    params["embed"] = L.with_f32_table(params["embed"])   # recurrentgemma ties embeddings
    return params


# -------------------------------------------------------------------- RG-LRU
def rglru(p, u, state, want_trail):
    """u: [B, Q, W] conv output; state: fp32 [B, W] or None (zeros).
    Returns (y fp32 [B, Q, W], final state [B, W], the per-token state
    trail [B, Q, W] or None)."""
    B, Q, W = u.shape
    r = torch.sigmoid(L.linear(p["gate_r"], u).float())
    i = torch.sigmoid(L.linear(p["gate_i"], u).float())
    log_a = -RGLRU_C * ssm._softplus(p["lam"]) * r                # [B, Q, W]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u.float())
    if state is None:
        state = torch.zeros((B, W), dtype=torch.float32, device=u.device)

    if Q == 1:
        h = a[:, 0] * state + gated[:, 0]
        y = h[:, None]
        return y, h, (y if want_trail else None)

    # log-step scan over (a, b): (a1, b1) then (a2, b2) composes to
    # (a1 a2, a2 b1 + b2); the initial state is folded into b_0
    b = torch.cat([(gated[:, 0] + a[:, 0] * state)[:, None], gated[:, 1:]], dim=1)
    step = 1
    while step < Q:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return b, b[:, -1], (b if want_trail else None)


def rec_unit(cfg, p, x, layer_cache, want_trail):
    """Recurrent temporal-mixing unit. layer_cache: {"state": [B, W],
    "conv": [B, 3, W]} or None (zero state, no cache). Returns (x, the new
    layer cache or None); with ``want_trail`` the new cache also holds
    "state_trail" [B, Q, W] and "conv_trail" [B, Q, 3, W]."""
    pm = p["mix"]
    h = L.rmsnorm(pm["norm"], x, cfg.norm_eps)
    gate = F.gelu(L.linear(pm["in_gate"], h), approximate="tanh")   # jax.nn.gelu
    u_raw = L.linear(pm["in_x"], h)
    conv_cache = layer_cache["conv"] if layer_cache is not None else None
    u, new_conv = ssm._causal_conv(u_raw, pm["conv_w"], pm["conv_b"], conv_cache)
    state = layer_cache["state"].float() if layer_cache is not None else None
    y, final, trail = rglru(pm, u, state, want_trail)
    y = y.to(x.dtype) * gate
    x = x + L.linear(pm["out"], y)
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
    if layer_cache is None:
        return x, None
    new_cache = {"state": final.to(layer_cache["state"].dtype),
                 "conv": new_conv.to(layer_cache["conv"].dtype)}
    if want_trail:
        # conv trail: the conv cache as it would be after each new token
        Q, K = x.shape[1], pm["conv_w"].shape[0]
        xfull = torch.cat([conv_cache.to(u_raw.dtype), u_raw], dim=1)
        conv_trail = torch.stack([xfull[:, j + 1:j + K] for j in range(Q)], dim=1)
        new_cache["state_trail"] = trail.to(layer_cache["state"].dtype)
        new_cache["conv_trail"] = conv_trail.to(layer_cache["conv"].dtype)
    return x, new_cache


def attn_unit(cfg, p, x, lc, ps: "dense.Pass"):
    """Local-attention unit: the dense family's attention sub-block over
    the layer's ring slice ``lc`` (None: the no-cache pass), windowed by
    ``cfg.local_window``."""
    x = x + dense.attn_block(cfg, p["mix"], x, ps.q_pos, lc, ps.index,
                             cfg.local_window, ps.block_table, None, None,
                             ps.ring)
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))


# ------------------------------------------------------------------- forward
def forward(cfg, params, tokens, cache=None, *, logits_slice=None,
            want_trail=False):
    """tokens: [B, Q] int. cache=None: the no-cache full-sequence pass (the
    paper's no-cache mode), returns (logits fp32, None). cache=dict (the
    flat layout of the module docstring): extend from the cached state and
    rings; returns the new cache (new state/conv stacks, the same ring
    buffers written in place) with index + Q, and with ``want_trail`` the
    per-token trails of the recurrent units."""
    x, ps = dense.begin(cfg, params, tokens, cache, cfg.local_window)
    Q = x.shape[1]
    new_rec, n_rec, n_att = [], 0, 0
    for lp, kind in zip(params["layers"], kinds(cfg), strict=True):
        if cache is None:     # checkpointed under cfg.remat, as JAX's scan
            unit = ((lambda h, lp=lp: rec_unit(cfg, lp, h, None, False)[0])
                    if kind == "rec" else
                    (lambda h, lp=lp: attn_unit(cfg, lp, h, None, ps)))
            x = L.maybe_remat(unit, cfg)(x)
        elif kind == "rec":
            lc = {"state": cache["state"][n_rec], "conv": cache["conv"][n_rec]}
            x, new_lc = rec_unit(cfg, lp, x, lc, want_trail)
            new_rec.append(new_lc)
            n_rec += 1
        else:
            x = attn_unit(cfg, lp, x, dense.layer_cache(cache, n_att), ps)
            n_att += 1
    new_cache = None
    if cache is not None:
        new_cache = {**{k: v for k, v in cache.items() if k not in TRAILS},
                     **{k: torch.stack([lc[k] for lc in new_rec])
                        for k in new_rec[0]},
                     "index": cache["index"] + Q}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:]
    return L.unembed(params["embed"], x), new_cache   # recurrentgemma ties embeddings


# --------------------------------------------------------------------- cache
def init_state(cfg, batch, dtype, device):
    """The recurrent units' zero state [L_rec, B, W] and conv [L_rec, B, 3,
    W] caches (the rings come from ``Model.init_cache``)."""
    n_rec = cfg.num_layers - n_attn(cfg)
    w = cfg.lru_width or cfg.d_model
    return {"state": torch.zeros((n_rec, batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((n_rec, batch, 3, w), dtype=dtype, device=device)}


def rollback(cache, accepted_index, q_len):
    """Attention units by index (the rings stay), recurrent units to the
    state at ``accepted_index`` in the verify's trails (``ssm.rollback``'s
    selection)."""
    kept = {k: v for k, v in cache.items() if k not in TRAILS}
    return {**kept, **ssm.rollback(cache, accepted_index, q_len)}
