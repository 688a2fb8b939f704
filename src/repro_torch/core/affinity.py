"""Device-affinity abstraction (paper §III-D; port of
``repro/core/affinity.py``).

The paper raises hardware placement into the compiler frontend: subgraphs
carry device affinities that the compiler resolves during lowering. Here
each partition (drafter / target) owns a ShardingPolicy whose ``model``
axis is the Submesh the DSE mapped it to; ``api/placement.py`` resolves the
roles to devices.

``resolve(mapping, mesh_axis_sizes)`` returns the (drafter_policy,
target_policy) pair.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.partition import Mapping, Submesh
from repro_torch.models.specs import ShardingPolicy


def policy_for(sub: Submesh, mesh_axis_sizes: Dict[str, int],
               data_axes: Tuple[str, ...] = ()) -> ShardingPolicy:
    """Build a ShardingPolicy whose tensor-parallel axis is the submesh.

    Axes of the mesh not in the submesh are left unused by this partition's
    weights, i.e. the partition is replicated across them — the idle-PU
    semantics of the paper's coarse-grained mapping.
    """
    model_ax = sub.axes if len(sub.axes) != 1 else sub.axes[0]
    if len(sub.axes) == 0:
        model_ax = None
    data_ax = data_axes if len(data_axes) != 1 else data_axes[0]
    if len(data_axes) == 0:
        data_ax = None
    return ShardingPolicy(data=data_ax, model=model_ax,
                          mesh_axis_sizes=dict(mesh_axis_sizes))


def resolve(mapping: Mapping, mesh_axis_sizes: Dict[str, int],
            data_axes: Tuple[str, ...] = ()) -> Tuple[ShardingPolicy, ShardingPolicy]:
    drafter_pol = policy_for(mapping.drafter, mesh_axis_sizes, data_axes)
    target_pol = policy_for(mapping.target, mesh_axis_sizes, data_axes)
    return drafter_pol, target_pol
