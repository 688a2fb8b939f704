"""Model and input-shape configuration (port of ``repro/configs/base.py``).

Same fields and defaults as the JAX ``ModelConfig`` for the six
families (dense, MoE, SSM, hybrid, encoder-decoder and VLM), with dtypes
resolved to ``torch`` dtypes. ``remat``/``remat_policy`` checkpoint each
layer of the no-cache forward in training (``models.layers.remat_wrap``).
``router_jitter`` is carried as JAX carries it and read nowhere, in JAX's
``models/moe.py`` as here. ``ShapeConfig``
and ``INPUT_SHAPES`` are the four assigned input shapes the planner
prices a model at.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads
    # --- attention ---
    sliding_window: Optional[int] = None   # None = full causal attention
    rope_theta: float = 1e4
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0            # llama4-style shared expert
    moe_every: int = 1                     # every k-th layer is MoE (llama4: 2)
    router_jitter: float = 0.0             # carried, unused (as in JAX)
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0                     # d_state N
    ssm_head_dim: int = 64                 # P
    ssm_expand: int = 2                    # d_inner = expand * d_model
    ssm_groups: int = 1                    # G (B/C groups)
    ssm_conv: int = 4                      # depthwise causal conv width
    ssm_chunk: int = 128                   # SSD chunk length
    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: Tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn"), cycled
    lru_width: int = 0                     # 0 -> d_model
    local_window: int = 2048               # local-attn window for hybrid blocks
    # --- encoder-decoder (whisper) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 1500                # frames after the (stubbed) conv frontend
    # --- VLM ---
    num_vision_tokens: int = 0             # patch embeddings fed by the (stubbed) ViT
    # --- execution ---
    remat: bool = False               # activation-checkpoint each layer (training)
    remat_policy: str = "full"        # "full" (recompute all) | "dots" (save matmul outputs)
    # --- numerics ---
    dtype: str = "bfloat16"                # activation dtype
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_init_scale: Optional[float] = None  # None keeps the std-1.0 table
    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count N (used for MODEL_FLOPS = 6*N*D)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (self.num_heads * hd) * d
        mlp = 3 * d * f
        if self.family == "moe":
            me = max(self.moe_every, 1)
            n_moe = L // me
            n_dense = L - n_moe
            moe_layer = attn + self.num_experts * mlp + d * self.num_experts \
                + self.num_shared_experts * mlp
            core = n_moe * moe_layer + n_dense * (attn + mlp)
        elif self.family == "ssm":
            di, N, G = self.d_inner, self.ssm_state, self.ssm_groups
            H = self.ssm_heads
            in_proj = d * (2 * di + 2 * G * N + H)
            per_layer = in_proj + self.ssm_conv * (di + 2 * G * N) + di * d + H
            core = L * per_layer
        elif self.family == "hybrid":
            w = self.lru_width or d
            rec = 2 * d * w + 3 * w * w // 1 + w * d  # in-proj(x2), gates+Λ approx, out
            n_attn = sum(1 for i in range(L) if self._block_kind(i) == "attn")
            n_rec = L - n_attn
            core = n_attn * (attn + mlp) + n_rec * (rec + mlp)
        elif self.family == "encdec":
            enc = self.num_encoder_layers * (attn + mlp)
            dec = L * (2 * attn + mlp)  # self + cross attention
            core = enc + dec
        else:
            core = L * (attn + mlp)
        return emb + core

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (self.num_heads * hd) * d
        mlp = 3 * d * f
        me = max(self.moe_every, 1)
        n_moe = L // me
        act = (L * attn + (L - n_moe) * mlp
               + n_moe * ((self.num_experts_per_tok + self.num_shared_experts) * mlp
                          + d * self.num_experts))
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + act

    def _block_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
