"""The sharding policy record (port of ``ShardingPolicy`` from
``repro/models/specs.py``).

A role's ``ShardingPolicy`` names the submesh axes that carry its batch
(``data``) and those that carry its tensors (``model``), with the size of
every axis; ``core/affinity.py`` and ``api/placement.py`` build one per
role. In the JAX package the spec-tree builders beside it (``param_specs``,
``cache_specs``, ``io_specs``, ``ns_tree``, ``sds_with``) turn the policy
into GSPMD shardings of a role's params, caches and token streams over its
submesh. Their counterpart is tensor parallelism of one role across several
CUDA devices, which no ported model has yet (ROADMAP.md, Queue 1): a role
of several devices runs on its first, and the policy is recorded.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple, Union

Axis = Union[str, Tuple[str, ...], None]


@dataclass(frozen=True)
class ShardingPolicy:
    data: Axis = "data"            # batch axis name(s) — ("pod","data") multi-pod
    model: Axis = "model"          # tensor axis name
    fsdp: bool = False             # additionally shard weights over `data`
    shard_experts: bool = True     # expert-parallel MoE when divisible
    expert_2d: bool = False        # also shard expert d_ff over `data` (huge MoE)
    replicate_batch: bool = False  # 2D-TP serving: batch replicated, weights 2D
    mesh_axis_sizes: dict = field(default_factory=dict)  # name -> size (for divisibility)

    def axis_size(self, ax: Axis) -> int:
        if ax is None:
            return 1
        names = (ax,) if isinstance(ax, str) else ax
        n = 1
        for a in names:
            n *= self.mesh_axis_sizes.get(a, 1)
        return n

    def batch_axis(self, batch: int) -> Axis:
        if self.replicate_batch:
            return None
        return self.data if batch % max(self.axis_size(self.data), 1) == 0 else None
