"""InternVL2-style VLM backbone (port of ``repro/models/vlm.py``;
arXiv:2404.16821).

The vision encoder (InternViT) is a STUB, as in JAX: the caller hands in
precomputed patch embeddings [B, n_patches, VIT_DIM] (``Model.
extra_inputs`` gives their shape). This module is the MLP projector and the
language model, the dense family's decoder, with the projected patches
prepended to the text.

Speculation runs on the language model as for the dense family: a cached
prefill consumes the vision prefix with the prompt, the prefix stays in
the ring, and every later cache index is the text length shifted by the
prefix (``RoundState.t_off``). The no-cache pass takes the patches on
every forward and returns logits for the text positions only, which sit at
positions n_patches.. as in JAX.

API:
  init(cfg, gen, device)                                -> params
  forward(cfg, params, tokens, cache, patches=None, ...) -> logits, new_cache
"""
from __future__ import annotations

import torch

from repro_torch.models import dense
from repro_torch.models import layers as L

VIT_DIM = 3200  # InternViT-6B hidden size (stub frontend output width)


def init(cfg, gen: torch.Generator, device):
    """The dense params plus the projector (fc1 VIT_DIM -> d_model, its
    input norm, fc2 d_model -> d_model)."""
    params = dense.init(cfg, gen, device)
    params["projector"] = {
        "fc1": L.init_linear(gen, VIT_DIM, cfg.d_model, cfg.weight_dtype, device),
        "norm": L.init_rmsnorm(VIT_DIM, cfg.weight_dtype, device),
        "fc2": L.init_linear(gen, cfg.d_model, cfg.d_model, cfg.weight_dtype,
                             device),
    }
    return params


def project(cfg, params, patches):
    """patches: [B, P, VIT_DIM] -> [B, P, d_model]: rmsnorm, fc1, gelu, fc2."""
    p = params["projector"]
    h = L.rmsnorm(p["norm"], patches.to(cfg.act_dtype), cfg.norm_eps)
    return L.linear(p["fc2"], L.gelu(L.linear(p["fc1"], h)))


def forward(cfg, params, tokens, cache, *, patches=None, logits_slice=None,
            max_live=None):
    """``patches=None`` is the dense forward (decode steps, the text-only
    per-row and paged paths). Otherwise the projected patches are
    prepended to the embedded tokens and the pass runs over both (a cached
    prefill writes both into the cache); logits come back for the text
    positions only, or for the last position with ``logits_slice="last"``."""
    if patches is None:
        return dense.forward(cfg, params, tokens, cache,
                             logits_slice=logits_slice, max_live=max_live)
    vis = project(cfg, params, patches)
    txt = L.embed(params["embed"], tokens).to(cfg.act_dtype)
    return dense.forward(cfg, params, None, cache,
                         input_embeds=torch.cat([vis, txt], dim=1),
                         logits_slice=logits_slice, max_live=max_live,
                         text_from=vis.shape[1])
