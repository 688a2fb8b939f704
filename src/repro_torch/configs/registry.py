"""Architecture registry: ``get(arch_id)`` -> module with config()/drafter_config()/smoke_config().

The paper's pair and the other dense configs (Granite 3.0 2B,
DeepSeek-Coder 33B, Llama 3 405B), Mamba-2 (ssm), the MoE configs
(Mixtral 8x7B, Llama 4 Maverick), RecurrentGemma 2B (hybrid), Whisper
large-v3 (encdec) and InternVL2-26B (vlm): every architecture of
``repro.configs.registry``.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "llama3.2-1b",
    "llama3.2-3b",
    "mamba2-780m",
    "granite-3-2b",
    "deepseek-coder-33b",
    "llama3-405b",
    "mixtral-8x7b",
    "llama4-maverick-400b-a17b",
    "recurrentgemma-2b",
    "whisper-large-v3",
    "internvl2-26b",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get(arch_id: str):
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")


def config(arch_id: str):
    return get(arch_id).config()


def drafter_config(arch_id: str):
    return get(arch_id).drafter_config()


def smoke_config(arch_id: str):
    return get(arch_id).smoke_config()
