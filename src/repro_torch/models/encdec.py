"""Whisper-style encoder-decoder backbone (port of ``repro/models/encdec.py``;
arXiv:2212.04356).

The mel-spectrogram and conv feature extractor is a STUB, as in JAX: the
caller hands in precomputed frame embeddings [B, encoder_seq, d_model]
(``Model.extra_inputs`` gives their shape). Everything downstream is here:
sinusoidal positions, the bidirectional encoder, the per-decoder-layer
cross-attention K/V of its output, and the decoder (causal self-attention
without RoPE, non-causal cross-attention, gelu MLP, tied unembedding).

JAX stacks each stack's layers on axis 0 and scans them; here
``params["enc_layers"]`` and ``params["dec_layers"]`` are lists of
per-layer dicts in forward order, as the other families keep theirs. The
cross K/V keep JAX's stacked layout, ``{"k", "v"}`` of [L_dec, B, T_enc,
Kv, D], so decoder layer l reads the contiguous slice [l]. The decoder's
self-attention cache is the dense family's ring (unwindowed); its
attention is the dense ``attn_block`` with ``use_rope=False``. The
encoder's attention and the cross-attention go through
``attention_flash`` with ``causal=False``: the flash kernel on the card,
its plain version on the CPU.

API:
  init(cfg, gen, device)                                -> params
  encode(cfg, params, frames)                           -> enc_out
  cross_kv(cfg, params, enc_out)                        -> {"k", "v"}
  forward(cfg, params, tokens, cache, cross=..., ...)   -> logits, new_cache
"""
from __future__ import annotations

import torch

from repro_torch.models import dense
from repro_torch.models import layers as L


def sinusoid(positions, d_model):
    """[..., S] int positions -> [..., S, d_model] fp32: sin then cos of
    positions x 10000^(-i / (half - 1)), i < half (JAX's denominator).
    ``log10k`` stays a 0-dim host tensor: a device op takes it as a scalar,
    so no pass copies it to the card (a copy would sync the host)."""
    half = d_model // 2
    log10k = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-log10k * ar / (half - 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------- init
def init_enc_layer(gen, cfg, device):
    return {"attn": dense.init_attn(gen, cfg, device),
            "mlp_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
            "mlp": L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.weight_dtype,
                                   device)}


def init_dec_layer(gen, cfg, device):
    return {"self": dense.init_attn(gen, cfg, device),
            "cross": dense.init_attn(gen, cfg, device),
            "mlp_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
            "mlp": L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.weight_dtype,
                                   device)}


def init(cfg, gen: torch.Generator, device):
    embed = L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.weight_dtype,
                             device, scale=cfg.embed_init_scale)
    return {
        "embed": L.with_f32_table(embed),       # whisper ties embeddings
        "enc_layers": [init_enc_layer(gen, cfg, device)
                       for _ in range(cfg.num_encoder_layers)],
        "enc_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
        "dec_layers": [init_dec_layer(gen, cfg, device)
                       for _ in range(cfg.num_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
    }


# ------------------------------------------------------------------- encoder
def _heads(cfg, p, x, n):
    B, T, _ = x.shape
    return L.linear(p, x).reshape(B, T, n, cfg.head_dim)


def encode(cfg, params, frames):
    """frames: [B, T_enc, D] precomputed frame embeddings (stub frontend)
    -> the normed encoder output [B, T_enc, D]."""
    B, T, _ = frames.shape
    pos = torch.arange(T, dtype=torch.int32, device=frames.device)
    x = frames.to(cfg.act_dtype) + sinusoid(pos, cfg.d_model).to(cfg.act_dtype)

    def enc_block(x, lp):
        pa = lp["attn"]
        hn = L.rmsnorm(pa["norm"], x, cfg.norm_eps)
        q = _heads(cfg, pa["q"], hn, cfg.num_heads)
        k = _heads(cfg, pa["k"], hn, cfg.num_kv_heads)
        v = _heads(cfg, pa["v"], hn, cfg.num_kv_heads)
        o = dense.attention_flash(q, k, v, causal=False)
        x = x + L.linear(pa["o"], o.reshape(B, T, cfg.num_heads * cfg.head_dim))
        return x + L.gelu_mlp(lp["mlp"], L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))

    enc_block = L.maybe_remat(enc_block, cfg)   # as JAX's scan
    for lp in params["enc_layers"]:
        x = enc_block(x, lp)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def cross_kv(cfg, params, enc_out):
    """Every decoder layer's cross-attention K/V of the encoder output:
    {"k", "v"} stacked [L_dec, B, T_enc, Kv, D]."""
    kv = [(_heads(cfg, lp["cross"]["k"], enc_out, cfg.num_kv_heads),
           _heads(cfg, lp["cross"]["v"], enc_out, cfg.num_kv_heads))
          for lp in params["dec_layers"]]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


# ------------------------------------------------------------------- decoder
def forward(cfg, params, tokens, cache, *, cross, logits_slice=None):
    """Decoder pass over tokens [B, Q]. ``cross``: ``cross_kv``'s stacked
    K/V (required). ``cache=None`` is the full causal pass (positions
    0..Q-1); otherwise the ring self-attention cache, written at its index
    and returned with index + Q."""
    x, ps = dense.begin(cfg, params, tokens, cache, None)
    B, Q, _ = x.shape
    x = x + sinusoid(ps.q_pos, cfg.d_model).to(cfg.act_dtype)
    width = cfg.num_heads * cfg.head_dim

    def dec_block(x, l, lp, ck, cv):
        # causal self-attention (ring-cached or not), no RoPE
        x = x + dense.attn_block(cfg, lp["self"], x, ps.q_pos,
                                 dense.layer_cache(cache, l), ps.index, None,
                                 ps.block_table, ps.max_live, None, ps.ring,
                                 use_rope=False)
        # cross-attention over the encoder's K/V, non-causal
        pc = lp["cross"]
        q = _heads(cfg, pc["q"], L.rmsnorm(pc["norm"], x, cfg.norm_eps),
                   cfg.num_heads)
        o = dense.attention_flash(q, ck, cv, causal=False)
        x = x + L.linear(pc["o"], o.reshape(B, Q, width))
        return x + L.gelu_mlp(lp["mlp"], L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))

    if cache is None:     # checkpointed under cfg.remat, as JAX's scan
        dec_block = L.maybe_remat(dec_block, cfg)
    for l, lp in enumerate(params["dec_layers"]):
        x = dec_block(x, l, lp, cross["k"][l], cross["v"][l])
    return dense.end(cfg, params, x, cache, logits_slice)
