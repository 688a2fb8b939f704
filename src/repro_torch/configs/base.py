"""Model configuration dataclass (port of ``repro/configs/base.py``).

Same fields and defaults as the JAX ``ModelConfig`` for the dense
(llama-style) family, with dtypes resolved to ``torch`` dtypes. The MoE,
SSM, hybrid, encoder-decoder and VLM fields wait for the slices that port
those families.
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

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
