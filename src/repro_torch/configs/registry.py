"""Architecture registry: ``get(arch_id)`` -> module with config()/drafter_config()/smoke_config().

The paper's pair (dense) and Mamba-2 (ssm) are ported so far; the other
architectures of ``repro.configs.registry`` join with the slices that port
their families.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "llama3.2-1b",
    "llama3.2-3b",
    "mamba2-780m",
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
