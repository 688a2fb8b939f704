"""Model configuration dataclass (port of ``repro/configs/base.py``).

Same fields and defaults as the JAX ``ModelConfig`` for the dense
(llama-style) and SSM (Mamba-2) families, with dtypes resolved to
``torch`` dtypes. The MoE, hybrid, encoder-decoder and VLM fields wait for
the slices that port those families.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

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
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0                     # d_state N
    ssm_head_dim: int = 64                 # P
    ssm_expand: int = 2                    # d_inner = expand * d_model
    ssm_groups: int = 1                    # G (B/C groups)
    ssm_conv: int = 4                      # depthwise causal conv width
    ssm_chunk: int = 128                   # SSD chunk length
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

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
