"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), port of
``repro/models/ssm.py``.

The sequence path is the chunked SSD algorithm (quadratic within chunks,
linear recurrence across chunk states): ``ssm_mix`` calls ``kernels.ops.
ssd_scan`` (the CUDA kernel on a CUDA tensor, the plain ``ssd_chunked`` on
a CPU tensor), from a zero state with no cache, and with a cache from the
cached state, taking the final state back from the kernel. Decode is the
token-by-token recurrence ``ssd_sequential`` on the cached state, used as
in JAX whenever Q <= 16 or the caller wants the trail.

Training: the SSD kernel has no backward pass. Where grad mode is on and an
input of the scan requires grad (a train step), the no-cache scan runs
``ssd_chunked`` itself, which autograd differentiates on either device:
the function JAX's model runs there (it never reaches its Pallas kernel).
The model chooses by grad mode, as ``kernels.flash_attention`` chooses its
autograd function; the kernel's wrapper still raises under grad.

Speculative rollback: an SSM state cannot be truncated like a KV ring, so
a multi-token extend with ``want_trail`` (the verify pass, Q = gamma + 1)
also returns per-token state and conv trails, and ``rollback`` selects the
state at the accepted position.

The JAX package stacks layer params on axis 0 and runs ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts and a Python loop runs
them, and a cached forward returns new state/conv tensors (stacked over
layers, as the scan's outputs are), never updating the old ones: the
stateful drafter keeps each draft step's state as its rollback snapshot.
The B/C group broadcast to heads is a stride-0 view (``expand``), not a
copy: the kernel reads every operand through its strides.

API:
  init(cfg, gen, device)                                   -> params
  forward(cfg, params, tokens, cache=None, logits_slice=None,
          want_trail=False)                                -> logits, new_cache
  rollback(cache, accepted_index, q_len)                   -> cache
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


# ---------------------------------------------------------------------- init
def _fixed_params(H, device):
    """A_log, D and dt_bias: deterministic, fp32 whatever the param dtype
    (as in JAX), computed on the CPU so every device holds the same bits."""
    return {
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)).to(device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        # softplus^-1(0.01)
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, dtype=torch.float32))).to(device),
    }


def init_layer(gen, cfg, device):
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * G * N
    dt = cfg.weight_dtype
    in_proj = L.init_linear(gen, d, 2 * di + 2 * G * N + H, dt, device)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen, dtype=torch.float32,
                         device=device) * (cfg.ssm_conv ** -0.5)
    return {
        "norm": L.init_rmsnorm(d, dt, device),
        "in_proj": in_proj,
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        **_fixed_params(H, device),
        "gate_norm": L.init_rmsnorm(di, dt, device),
        "out_proj": L.init_linear(gen, di, d, dt, device),
    }


def init(cfg, gen: torch.Generator, device):
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.weight_dtype, device,
                                  scale=cfg.embed_init_scale),
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.num_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
    }
    params["embed"] = L.with_f32_table(params["embed"])   # mamba2 ties embeddings
    return params


# ---------------------------------------------------------------------- SSD
def _segsum(x):
    """[..., T] -> [..., T, T] cumulative segment sums, -inf above diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x, dA, Bm, Cm, chunk, init_state):
    """Chunked SSD scan.

    x:  [b, l, h, p]   (pre-multiplied by dt)
    dA: [b, l, h]      (log-decay = dt * A, negative)
    Bm, Cm: [b, l, h, n] (groups already broadcast to heads)
    init_state: [b, h, p, n]
    Returns (y [b,l,h,p], final_state [b,h,p,n]).
    """
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    lc = x.shape[1]
    c, q = lc // chunk, chunk
    X = x.reshape(b, c, q, h, p)
    A = dA.reshape(b, c, q, h).permute(0, 3, 1, 2)              # [b,h,c,q]
    Bc = Bm.reshape(b, c, q, h, n)
    Cc = Cm.reshape(b, c, q, h, n)

    A_cs = torch.cumsum(A, dim=-1)                               # [b,h,c,q]
    Ldec = torch.exp(_segsum(A))                                 # [b,h,c,q,q]
    Y_diag = torch.einsum("bcqhn,bckhn,bhcqk,bckhp->bcqhp", Cc, Bc, Ldec, X)

    decay_states = torch.exp(A_cs[..., -1:] - A_cs)              # [b,h,c,q]
    states = torch.einsum("bckhn,bhck,bckhp->bchpn", Bc, decay_states, X)
    states = torch.cat([init_state[:, None], states], dim=1)     # [b,c+1,h,p,n]
    chunk_tot = F.pad(A_cs[..., -1], (1, 0))                     # [b,h,c+1]
    decay_chunk = torch.exp(_segsum(chunk_tot))                  # [b,h,c+1,c+1]
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    state_decay_out = torch.exp(A_cs)                            # [b,h,c,q]
    Y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", Cc, prev_states, state_decay_out)
    Y = (Y_diag + Y_off).reshape(b, lc, h, p)[:, :l]
    return Y, final_state


def ssd_sequential(x, dA, Bm, Cm, init_state):
    """Token-by-token recurrence; returns (y [b,q,h,p], final state
    [b,h,p,n], the per-token state trail [b,q,h,p,n])."""
    state = init_state
    ys, trail = [], []
    for t in range(x.shape[1]):
        state = torch.exp(dA[:, t])[..., None, None] * state \
            + torch.einsum("bhp,bhn->bhpn", x[:, t], Bm[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], state))
        trail.append(state)
    return torch.stack(ys, dim=1), state, torch.stack(trail, dim=1)


# ------------------------------------------------------------------- forward
def _causal_conv(xBC, w, b, conv_cache=None):
    """Depthwise causal conv. xBC: [B,Q,CH]; w: [K,CH]; conv_cache:
    [B,K-1,CH] or None (zero history). Returns (out, the last K-1 inputs:
    the new conv cache)."""
    K = w.shape[0]
    if conv_cache is not None:
        xfull = torch.cat([conv_cache.to(xBC.dtype), xBC], dim=1)
    else:
        xfull = F.pad(xBC, (0, 0, K - 1, 0))
    # window sum: out[t] = sum_k w[k] * xfull[t+k]
    Q = xBC.shape[1]
    out = torch.zeros_like(xBC)
    for k in range(K):
        out = out + xfull[:, k:k + Q] * w[k].to(xBC.dtype)
    new_conv = xfull[:, -(K - 1):] if K > 1 else None
    return out + b.to(xBC.dtype), new_conv


def _softplus(v):
    # jax.nn.softplus is logaddexp(v, 0)
    return torch.logaddexp(v, torch.zeros_like(v))


def _heads(m, B, Q, G, N, H):
    """[B, Q, G*N] -> fp32 [B, Q, H, N], each group broadcast to its H/G
    heads (a stride-0 view when G = 1)."""
    m = m.reshape(B, Q, G, 1, N).float()
    return m.expand(B, Q, G, H // G, N).reshape(B, Q, H, N)


def ssm_mix(cfg, p, x, layer_cache=None, want_trail=False):
    """The mamba2 mixer. layer_cache: {"state": [B,H,P,N], "conv":
    [B,K-1,CH]} or None (zero state, no cache). Returns (x + out, the new
    layer cache or None); with ``want_trail`` the new cache also holds
    "state_trail" [B,Q,H,P,N] and "conv_trail" [B,Q,K-1,CH]."""
    from repro_torch.kernels import ops
    B, Q, _ = x.shape
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    zxbcdt = L.linear(p["in_proj"], h)
    z, xBC_raw, dt_raw = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    conv_cache = layer_cache["conv"] if layer_cache is not None else None
    xBC, new_conv = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"], conv_cache)
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, Q, H, P)
    dt = _softplus(dt_raw.float() + p["dt_bias"])                   # [B,Q,H]
    A = -torch.exp(p["A_log"])                                       # [H]
    dA = (dt * A).float()
    x_eff = xs.float() * dt[..., None]
    Bf, Cf = _heads(Bm, B, Q, G, N, H), _heads(Cm, B, Q, G, N, H)
    trail = None
    if layer_cache is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_eff, dA, Bf, Cf)):
        y, _ = ssd_chunked(x_eff, dA, Bf, Cf, cfg.ssm_chunk,
                           x_eff.new_zeros((B, H, P, N)))
    elif layer_cache is None:
        y = ops.ssd_scan(x_eff, dA, Bf, Cf, chunk=cfg.ssm_chunk)
    else:
        init_state = layer_cache["state"].float()
        if Q <= 16 or want_trail:
            y, final_state, trail = ssd_sequential(x_eff, dA, Bf, Cf, init_state)
        else:
            y, final_state = ops.ssd_scan(x_eff, dA, Bf, Cf, chunk=cfg.ssm_chunk,
                                          init_state=init_state)
    y = y + p["D"][:, None] * xs.float()
    y = y.reshape(B, Q, di).to(x.dtype)
    y = L.rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = x + L.linear(p["out_proj"], y)
    if layer_cache is None:
        return out, None
    new_cache = {"state": final_state.to(layer_cache["state"].dtype),
                 "conv": new_conv.to(layer_cache["conv"].dtype)}
    if want_trail:
        # conv trail: the conv cache as it would be after each new token
        K = cfg.ssm_conv
        xfull = torch.cat([conv_cache.to(x.dtype), xBC_raw], dim=1)
        conv_trail = torch.stack([xfull[:, j + 1:j + K] for j in range(Q)], dim=1)
        new_cache["state_trail"] = trail.to(layer_cache["state"].dtype)
        new_cache["conv_trail"] = conv_trail.to(layer_cache["conv"].dtype)
    return out, new_cache


def forward(cfg, params, tokens, cache=None, *, logits_slice=None,
            want_trail=False):
    """tokens: [B, Q] int. cache=None: the no-cache full-sequence pass (the
    paper's no-cache mode), returns (logits fp32, None). cache=dict
    ({"state", "conv", "index"}): extend from the cached state; returns the
    new cache (new tensors, stacked over layers) with index + Q, and with
    ``want_trail`` the per-token trails."""
    x = L.embed(params["embed"], tokens).to(cfg.act_dtype)
    Q = x.shape[1]
    new_layers = []
    for l, lp in enumerate(params["layers"]):
        if cache is None:     # checkpointed under cfg.remat, as JAX's scan
            x = L.maybe_remat(lambda h, lp=lp: ssm_mix(cfg, lp, h)[0], cfg)(x)
            continue
        lc = {"state": cache["state"][l], "conv": cache["conv"][l]}
        x, new_lc = ssm_mix(cfg, lp, x, lc, want_trail)
        new_layers.append(new_lc)
    new_cache = None
    if cache is not None:
        new_cache = {k: torch.stack([lc[k] for lc in new_layers])
                     for k in new_layers[0]}
        new_cache["index"] = cache["index"] + Q
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:]
    return L.unembed(params["embed"], x), new_cache   # mamba2 ties embeddings


def rollback(cache, accepted_index, q_len):
    """Select the state at ``accepted_index`` from the verification trail
    (``accepted_index`` and the cache's index are 0-dim tensors; the trail
    position is gathered on the device)."""
    old_index = cache["index"] - q_len
    j = torch.clamp(accepted_index - old_index - 1, 0, q_len - 1)
    j = torch.as_tensor(j, device=cache["state_trail"].device).long().reshape(1)
    state = torch.index_select(cache["state_trail"], 2, j)[:, :, 0]
    conv = torch.index_select(cache["conv_trail"], 2, j)[:, :, 0]
    return {"state": state, "conv": conv,
            "index": torch.as_tensor(accepted_index, dtype=torch.int32,
                                     device=cache["index"].device)}
