"""Model API (port of ``repro/models/model.py``: the six families).

  model = build_model(cfg)
  params = model.init(seed, device)
  logits, cache, aux = model.apply(params, tokens, cache, **kw, **extras)
  logits, _, _ = model.apply(params, tokens)       # no-cache full pass
  cache  = model.init_cache(batch, max_len, spec_slack)      (ring / state)
  spec   = model.cache_spec(batch, max_len, spec_slack)      (meta tensors)
  cache  = model.init_paged_cache(batch, num_blocks, block_size, max_blocks_per_row)
  cache' = model.rollback(cache, accepted_index, q_len)      (O(1) / trail)
  shapes = model.extra_inputs(batch)                         (stub frontends)

``extras`` carries the modality front ends' stand-ins, as in JAX:
``patches`` (vlm: [B, num_vision_tokens, VIT_DIM] patch embeddings) and
``frames`` or ``cross`` (encdec: [B, encoder_seq, d_model] frame
embeddings, or the cross-attention K/V ``apply`` returned as aux).

``init``, ``init_cache`` and ``init_paged_cache`` allocate on ``cuda``
unless the caller passes ``device="cpu"``. The dense family's
``init_cache`` is a ring KV cache: max_len slots, or for a windowed config
min(max_len, window + spec_slack) as in JAX, rounded up to a multiple of
``dense.RING_PAGE`` so the paged kernel can read it as a pool of pages. A
windowed ring with fewer slots than max_len wraps; it keeps how many
positions its read table reaches (``positions``, max_len rounded up to the
page), and the dense forward reads it through a table over positions
(``models.dense``). The ssm family's is the recurrent state and
conv caches, both in the activation dtype as in JAX. The moe family's
caches are the dense family's over the layers its blocks hold
(``moe.n_layers``), one [L, ...] K and V buffer in forward order where JAX
nests them by block kind (``models.moe``). The hybrid family's cache is
flat (``models.hybrid``): the recurrent units' state and conv stacks, in
the activation dtype, beside a ring over its attention units, sized by
``cfg.local_window`` + spec_slack as JAX sizes it. A bf16 state is
rounded after every cached pass: cached AR rounds it once a token, a
speculative round once a round (through the verify's trail), and the
no-cache pass never, so the three drift apart at bf16 (not at fp32).
Neither recurrent family has a paged cache (JAX has none either). The
VLM's caches are the dense family's, sized by ``cache_len`` to hold the
vision prefix beside the text (the per-row and paged paths take the VLM
text-only, as JAX's do). The encoder-decoder's is an unwindowed ring over
its decoder layers; it has no paged cache, as in JAX.
``apply`` returns the moe family's aux losses (load balance, router z),
the encoder-decoder's cross K/V (``{"cross": ...}``, computed from
``frames`` when no ``cross`` is given) and ``{}`` for the others.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import device as devices
from repro_torch.cache import kv_cache, paged_kv
from repro_torch.models import dense, encdec, hybrid, moe, ssm, vlm

FAMILIES = {"dense": dense, "moe": moe, "ssm": ssm, "hybrid": hybrid,
            "vlm": vlm, "encdec": encdec}
RECURRENT = ("ssm", "hybrid")     # families with state caches and trails


class Model:
    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet "
                f"(ported: {sorted(FAMILIES)})")
        self.cfg = cfg
        self.family = cfg.family

    def init(self, seed: Union[int, torch.Generator], device=None,
             layer_fn=None):
        """Seeded random weights. ``seed`` is an int or a torch.Generator
        on ``device``. ``layer_fn`` (moe family) maps each layer's params
        as it is made, before the next layer is; the draws do not change.
        On the ``meta`` device the tree holds the same shapes and dtypes
        and nothing is drawn (``seed`` is ignored): the port's
        ``jax.eval_shape(lambda: model.init(rng))``."""
        dev = devices.resolve(device)
        gen = seed
        if dev.type == "meta":
            gen = None
        elif not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        if layer_fn is None:
            return FAMILIES[self.family].init(self.cfg, gen, dev)
        if self.family != "moe":
            raise NotImplementedError("layer_fn takes the moe family's layers")
        return moe.init(self.cfg, gen, dev, layer_fn)

    def apply(self, params, tokens, cache=None, *, want_trail=False,
              logits_slice=None, max_live=None, tree=None, patches=None,
              frames=None, cross=None):
        """``cache=None`` runs the no-cache full-sequence pass and returns
        (logits, None, aux). ``want_trail``: ssm and hybrid caches only —
        also return the per-token state and conv trails ``rollback``
        selects from.
        ``max_live``: paged caches only. ``tree`` = (depths, bits) int32 [Q]
        runs a stacked tree-verify pass (``core.tree``; dense family).
        ``patches`` (vlm) prepends the projected patches and returns the
        text positions' logits. ``cross`` (encdec) is the decoder's
        cross K/V; without it ``frames`` are encoded first, and without
        either the call raises, as JAX's does. Other families ignore the
        extras, as JAX's do."""
        cfg = self.cfg
        if tree is not None and self.family != "dense":
            raise NotImplementedError(
                f"tree-verify passes need a dense-family target (got {self.family!r})")
        if self.family == "vlm":
            logits, new_cache = vlm.forward(cfg, params, tokens, cache,
                                            patches=patches,
                                            logits_slice=logits_slice,
                                            max_live=max_live)
            return logits, new_cache, {}
        if self.family == "encdec":
            if cross is None:
                if frames is None:
                    raise ValueError("encdec needs frames or precomputed cross KV")
                cross = self.encode(params, frames)
            logits, new_cache = encdec.forward(cfg, params, tokens, cache,
                                               cross=cross,
                                               logits_slice=logits_slice)
            return logits, new_cache, {"cross": cross}
        if self.family == "moe":
            return moe.forward(self.cfg, params, tokens, cache,
                               logits_slice=logits_slice, max_live=max_live)
        if self.family in RECURRENT:
            fwd = FAMILIES[self.family].forward
            logits, new_cache = fwd(self.cfg, params, tokens, cache,
                                    logits_slice=logits_slice,
                                    want_trail=want_trail)
            return logits, new_cache, {}
        logits, new_cache = dense.forward(self.cfg, params, tokens, cache,
                                          logits_slice=logits_slice,
                                          max_live=max_live, tree=tree)
        return logits, new_cache, {}

    def encode(self, params, frames):
        """encdec: the decoder's cross K/V of ``frames`` (the encoder, then
        every decoder layer's K/V projections), as ``apply`` returns it."""
        return encdec.cross_kv(self.cfg, params,
                               encdec.encode(self.cfg, params, frames))

    # ----------------------------------------------------------------- cache
    def _kv_layers(self):
        """Layers holding KV: every layer, or the moe family's blocks'."""
        if self.family == "moe":
            return moe.n_layers(self.cfg)
        return self.cfg.num_layers

    def cache_len(self, text_len: int) -> int:
        """Cache capacity needed for ``text_len`` text positions (the VLM's
        cache also holds its vision tokens)."""
        if self.family == "vlm":
            return text_len + self.cfg.num_vision_tokens
        return text_len

    def _kv_window(self, spec_slack):
        w = self.cfg.sliding_window
        return None if w is None else w + spec_slack

    def init_cache(self, batch, max_len, spec_slack=8,
                   dtype: Optional[torch.dtype] = None, device=None):
        """dense: ring KV buffers [L, batch, W, Kv, D] with W = max_len, or
        min(max_len, window + spec_slack) for a windowed config (JAX's
        sizing; the slack covers what a round writes past the committed
        length), rounded up to a multiple of ``dense.RING_PAGE``; a ring
        with fewer slots than that many positions also holds
        ``positions`` (moe: the same over ``moe.n_layers`` layers). ssm:
        state [L, batch, H, P, N] and conv
        [L, batch, K-1, CH] caches. hybrid: state [L_rec, batch, W] and
        conv [L_rec, batch, 3, W], and the dense ring over its L_attn
        attention units with ``cfg.local_window`` as the window. vlm: the
        dense ring (callers size it by ``cache_len``). encdec: an
        unwindowed ring over the decoder layers. Index 0."""
        cfg = self.cfg
        dtype = dtype or cfg.act_dtype
        dev = devices.resolve(device)
        if self.family == "ssm":
            G, N, K = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
            ch = cfg.d_inner + 2 * G * N
            return {"state": torch.zeros((cfg.num_layers, batch, cfg.ssm_heads,
                                          cfg.ssm_head_dim, N),
                                         dtype=dtype, device=dev),
                    "conv": torch.zeros((cfg.num_layers, batch, K - 1, ch),
                                        dtype=dtype, device=dev),
                    "index": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.family == "hybrid":
            ring = self._ring(hybrid.n_attn(cfg), batch, max_len,
                              cfg.local_window + spec_slack, dtype, dev)
            return {**hybrid.init_state(cfg, batch, dtype, dev), **ring}
        if self.family == "encdec":
            return self._ring(cfg.num_layers, batch, max_len, None, dtype, dev)
        return self._ring(self._kv_layers(), batch, max_len,
                          self._kv_window(spec_slack), dtype, dev)

    def cache_spec(self, batch, max_len, spec_slack=8,
                   dtype: Optional[torch.dtype] = None):
        """``init_cache``'s tree on the ``meta`` device: every leaf's shape
        and dtype, no memory (JAX's ``jax.eval_shape`` of its
        ``init_cache``). The layout is the port's (flat moe and hybrid
        caches, rings rounded up to ``dense.RING_PAGE`` slots)."""
        return self.init_cache(batch, max_len, spec_slack, dtype, device="meta")

    def _ring(self, n_layers, batch, max_len, window, dtype, dev):
        """Ring K/V buffers over ``n_layers`` layers: buffer_len(max_len,
        window) slots rounded up to a multiple of ``dense.RING_PAGE``, and
        ``positions`` when that is fewer than max_len (rounded up)."""
        cfg = self.cfg
        page = dense.RING_PAGE
        W = kv_cache.buffer_len(max_len, window)
        W = -(-W // page) * page
        cache = kv_cache.init_cache(n_layers, batch, W, cfg.num_kv_heads,
                                    cfg.head_dim, dtype=dtype, device=dev)
        positions = -(-max_len // page) * page
        if positions > W:
            cache["positions"] = positions
        return cache

    def init_paged_cache(self, batch, num_blocks, block_size,
                         max_blocks_per_row, dtype: Optional[torch.dtype] = None,
                         device=None):
        """Block-pool KV cache for ragged continuous batching (the dense,
        moe and vlm families only: recurrent state needs no paging, and the
        encoder-decoder has none, as in JAX)."""
        if self.family in RECURRENT or self.family == "encdec":
            raise ValueError(f"paged KV cache unsupported for family {self.family!r}")
        cfg = self.cfg
        return paged_kv.init_cache(self._kv_layers(), batch, num_blocks,
                                   block_size, max_blocks_per_row,
                                   cfg.num_kv_heads, cfg.head_dim,
                                   dtype or cfg.act_dtype,
                                   devices.resolve(device))

    # -------------------------------------------------------------- rollback
    def rollback(self, cache, accepted_index, q_len):
        if self.family in RECURRENT:
            return FAMILIES[self.family].rollback(cache, accepted_index, q_len)
        return kv_cache.rollback(cache, accepted_index)

    # --------------------------------------------- modality frontend stand-ins
    def extra_inputs(self, batch, dtype: Optional[torch.dtype] = None) -> dict:
        """{name: (shape, dtype)} of the stub front ends' inputs: the VLM's
        ``patches``, the encoder-decoder's ``frames``; {} for the text
        families."""
        dtype = dtype or self.cfg.act_dtype
        if self.family == "vlm":
            return {"patches": ((batch, self.cfg.num_vision_tokens, vlm.VIT_DIM),
                                dtype)}
        if self.family == "encdec":
            return {"frames": ((batch, self.cfg.encoder_seq, self.cfg.d_model),
                               dtype)}
        return {}


def build_model(cfg) -> Model:
    return Model(cfg)
