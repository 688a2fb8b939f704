"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060): the no-cache
path of ``repro/models/ssm.py``.

The sequence path is the chunked SSD algorithm (quadratic within chunks,
linear recurrence across chunk states). With no cache the scan starts from
a zero state and its final state is not needed, which is exactly the
function of the fused scan kernel: ``ssm_mix`` calls ``kernels.ops.
ssd_scan`` (the CUDA kernel on a CUDA tensor, the plain ``ssd_chunked``
on a CPU tensor). ``ssd_chunked`` with an initial state and the final
state is kept whole: it is the plain version and the tests' oracle.

The JAX package stacks layer params on axis 0 and runs ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts and a Python loop runs
them. The B/C group broadcast to heads is a stride-0 view (``expand``), not
a copy: the kernel reads every operand through its strides. The cached
path (``ssd_sequential``, the state and conv trails, ``rollback``) waits
for a later slice.

API:
  init(cfg, gen, device)                         -> params
  forward(cfg, params, tokens, logits_slice=None) -> logits, None
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


# ------------------------------------------------------------------- forward
def _causal_conv(xBC, w, b, conv_cache=None):
    """Depthwise causal conv. xBC: [B,Q,CH]; w: [K,CH]. Returns (out, the
    last K-1 inputs). The cached branch waits for the cached SSM path."""
    if conv_cache is not None:
        raise NotImplementedError("the cached conv is not ported (no-cache path only)")
    K = w.shape[0]
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


def ssm_mix(cfg, p, x):
    """The mamba2 mixer, no cache (zero initial state)."""
    from repro_torch.kernels import ops
    B, Q, _ = x.shape
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    zxbcdt = L.linear(p["in_proj"], h)
    z, xBC_raw, dt_raw = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xBC, _ = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, Q, H, P)
    dt = _softplus(dt_raw.float() + p["dt_bias"])                   # [B,Q,H]
    A = -torch.exp(p["A_log"])                                       # [H]
    dA = (dt * A).float()
    x_eff = xs.float() * dt[..., None]
    y = ops.ssd_scan(x_eff, dA, _heads(Bm, B, Q, G, N, H),
                     _heads(Cm, B, Q, G, N, H), chunk=cfg.ssm_chunk)
    y = y + p["D"][:, None] * xs.float()
    y = y.reshape(B, Q, di).to(x.dtype)
    y = L.rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return x + L.linear(p["out_proj"], y)


def forward(cfg, params, tokens, cache=None, *, logits_slice=None):
    """tokens: [B, Q] int; the no-cache full-sequence pass (the paper's
    no-cache mode). Returns (logits fp32, None)."""
    if cache is not None:
        raise NotImplementedError(
            "the cached SSM forward (state/conv caches, trails, rollback) "
            "is not ported yet: a later slice adds it")
    x = L.embed(params["embed"], tokens).to(cfg.act_dtype)
    for lp in params["layers"]:
        x = ssm_mix(cfg, lp, x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:]
    return L.unembed(params["embed"], x), None
