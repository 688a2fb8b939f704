"""Greedy speculative verification on Hopper: the row-argmax kernel's
wrapper, launch count and plain version, plus the fused verify.

Replaces the Pallas TPU kernel ``repro/kernels/spec_verify.py::
blockwise_argmax`` and its caller ``verify_greedy_fused``. The kernel is
``repro_torch/csrc/spec_verify.cu`` (its header says what bounds it on the
H100 and how the design answers); ``plain`` is ``torch.argmax``, which
also returns the first maximum.

``blockwise_argmax`` takes the plain version for a CPU tensor. For a CUDA
tensor it launches the kernel — counting the launch in
``blockwise_argmax.launches`` — or raises; it never falls back. ``plan``
sizes the launch: one thread block cluster per row. The acceptance
epilogue stays in plain torch on the tensor's device, as the JAX version
leaves it in jnp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.acceptance import VerifyResult, verify_from_argmax
from repro_torch.kernels import build
from repro_torch.kernels.ref import blockwise_argmax_ref as plain


MAX_CLUSTER = 8      # the portable cluster size (csrc: kMaxCluster)
PER_BLOCK = 4096     # logits a block of a row's cluster takes at least


class ArgmaxPlan(NamedTuple):
    cluster: int         # blocks per row: one thread block cluster
    blocks: int          # blocks of the launch


def plan(R: int, V: int) -> ArgmaxPlan:
    """The launch of one call: the largest power of two up to MAX_CLUSTER
    blocks per row that leaves each at least PER_BLOCK logits (one block
    for a short row). Nothing here depends on the card."""
    cluster = 1
    while cluster < MAX_CLUSTER and V >= 2 * cluster * PER_BLOCK:
        cluster *= 2
    return ArgmaxPlan(cluster, cluster * R)


def blockwise_argmax(logits):
    """logits: [R, V] fp32 -> argmax int32 [R, 1] (first maximum)."""
    if logits.device.type == "cpu":
        return plain(logits)
    build.check_no_grad("blockwise argmax", logits)
    if logits.device.type != "cuda":
        raise ValueError(f"argmax: unsupported device {logits.device}")
    if logits.dtype != torch.float32 or logits.ndim != 2:
        raise TypeError(f"argmax kernel takes [R, V] fp32 logits, got "
                        f"{tuple(logits.shape)} {logits.dtype}")
    logits = logits.contiguous()
    R, V = logits.shape
    lib = build.load("spec_verify")
    out = torch.empty((R,), dtype=torch.int32, device=logits.device)
    err = build.call(lib.row_argmax, logits.device, logits.data_ptr(),
                     out.data_ptr(), R, V, plan(R, V).cluster)
    build.check(err, "row_argmax")
    blockwise_argmax.launches += 1
    return out[:, None]


blockwise_argmax.launches = 0


def verify_greedy_fused(draft_tokens, p_logits) -> VerifyResult:
    """Drop-in for ``core.acceptance.verify_greedy`` on the argmax kernel.

    draft_tokens: [B, G]; p_logits: [B, G+1, V]."""
    B, G1, V = p_logits.shape
    tgt = blockwise_argmax(p_logits.reshape(B * G1, V))[:, 0].reshape(B, G1)
    return verify_from_argmax(draft_tokens, tgt)
