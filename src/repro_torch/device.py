"""Device selection for the port's entry points.

Entry points default to the GPU: ``resolve(None)`` is ``cuda`` and raises
when no CUDA device is visible. The CPU is used only when the caller asks
for it (``device="cpu"``), as the tests do — a run never drops silently to
the CPU.
"""
from __future__ import annotations

import functools
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


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device`` (read once per
    card): the kernels' launch plans size their grids by it."""
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def synchronize(device: torch.device):
    """Wait for the work queued on ``device``: the traced spans' counterpart
    of ``jax.block_until_ready``. Eager CPU ops have finished when they
    return, so on the CPU there is nothing to wait for."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def visible(device: Optional[Union[str, torch.device]] = None) -> list:
    """The devices a placement carves its roles from: every visible CUDA
    device for ``cuda`` (the default; raises when none is visible), else
    the one device asked for (``"cpu"``)."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]
