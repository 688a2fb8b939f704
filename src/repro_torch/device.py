"""Device selection for the port's entry points.

Entry points default to the GPU: ``resolve(None)`` is ``cuda`` and raises
when no CUDA device is visible. The CPU is used only when the caller asks
for it (``device="cpu"``), as the tests do — a run never drops silently to
the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
