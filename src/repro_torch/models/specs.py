"""Partition-spec derivation for params, caches and step inputs/outputs
(port of ``repro/models/specs.py``).

Specs are derived *structurally*, as in JAX: walk the param (or cache)
tree and give each leaf a spec from its path and rank. A spec is a plain
tuple with one entry per dim: ``None`` (not sharded), an axis name, or a
tuple of axis names; it plays the part of JAX's ``PartitionSpec``, and
``tuple(P(...))`` of JAX's is the port's.

The trees are the port's: MoE and hybrid params are flat lists of layers
in forward order and hybrid caches flat stacks (``models.moe``,
``models.hybrid``), where JAX stacks each block kind on a leading axis.
Every rule reads a leaf's dims from the end (``rank - 1``, ``rank - 2``,
``rank - 3``) and its path by name, never by position, so a port leaf's
spec is JAX's spec of the matching leaf with JAX's leading stack dim
dropped (``tests/test_torch_specs.py`` holds this leaf for leaf). The one
leaf JAX has no counterpart of, the tied table's fp32 copy
``embed/table_f32``, takes ``embed/table``'s spec.

Baseline layout (megatron-style):
  * attention q/k/v: output (heads) on ``model``;  o: input on ``model``
  * mlp gate/up: d_ff on ``model``;  down: d_ff (input) on ``model``
  * embeddings & lm_head: vocab on ``model``
  * MoE experts: expert axis on ``model`` when divisible, else d_ff
  * batch on ``data`` (and ``pod``) when divisible, else replicated
  * with ``fsdp=True``, the non-model axis of every weight is additionally
    sharded over ``data`` (ZeRO-3 style; used by the train step)

``ns_tree``'s counterpart is ``shard_plan``: a spec tree and a role's
submesh (axis names and sizes, devices in mesh order) give each leaf the
slice every device holds. ``sds_with``'s is ``local_shapes``: a meta tree's
per-device shapes under a spec tree. ``parallel.tp`` realizes the dense
family's serving layout over a role's model axis from these specs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple, Union

import numpy as np

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


# ------------------------------------------------------------------ tree walk
def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over the tensor leaves of a dict/list tree; the
    path joins dict keys and list indices with "/" (JAX's ``_path_str``).
    Leaves that are not arrays (a ring's ``positions`` count) map to
    None."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree) if _is_leaf(tree) else None


def _wspec(pol: ShardingPolicy, rank: int, shard_dim: int, leaf, stacked_dims: int):
    """Weight spec: `shard_dim` (relative to the matrix dims) on model axis.
    `stacked_dims` leading axes (layer/expert stacks) are unsharded unless noted."""
    spec = [None] * rank
    mat_start = stacked_dims
    spec[mat_start + shard_dim] = pol.model
    if pol.fsdp:
        other = mat_start + (1 - shard_dim)
        size = pol.axis_size(pol.data)
        if leaf.shape[other] % max(size, 1) == 0 and size > 1:
            spec[other] = pol.data
    return tuple(spec)


OUT_SHARDED = ("q", "k", "v", "gate", "up", "fc1", "in_x", "in_gate",
               "in_proj", "gate_r", "gate_i", "lm_head")


def _quant_scale_spec(ps, leaf, pol, m_size):
    """Spec for int8 per-output-channel scales [..., N]: follows the sibling
    weight's output-dim sharding; K-sharded weights have replicated scales."""
    rank = len(leaf.shape)
    parent = ps.rsplit("/", 2)[-2]
    spec = [None] * rank
    if "/experts/" in ps:
        # expert scales [L, E, N] (or [L, E, D] for down): expert dim rank-2
        if pol.shard_experts and leaf.shape[rank - 2] % max(m_size, 1) == 0:
            spec[rank - 2] = pol.model
            if pol.expert_2d and not ps.endswith("down/scale"):
                d_size = pol.axis_size(pol.data)
                if d_size > 1 and leaf.shape[-1] % d_size == 0:
                    spec[-1] = pol.data
            return tuple(spec)
        if parent in ("gate", "up") and leaf.shape[-1] % max(m_size, 1) == 0:
            spec[-1] = pol.model
        return tuple(spec)
    if parent in OUT_SHARDED and leaf.shape[-1] % max(m_size, 1) == 0:
        spec[-1] = pol.model
    return tuple(spec)


def param_specs(cfg, params_shape, pol: ShardingPolicy):
    """params_shape: the port's param tree, on any device (``Model.init(0,
    "meta")`` holds only shapes)."""
    m_size = pol.axis_size(pol.model)

    def rule(path, leaf):
        ps = path.replace("/w_q", "/w")   # int8 weights share w rules
        if ps.endswith("embed/table_f32"):     # the tied table's fp32 copy
            ps = ps[:-len("_f32")]
        rank = len(leaf.shape)
        if ps.endswith("/scale") and "norm" not in ps.rsplit("/", 2)[-2]:
            return _quant_scale_spec(ps, leaf, pol, m_size)

        def div(dim_idx):
            return leaf.shape[dim_idx] % max(m_size, 1) == 0
        none = (None,) * rank

        # ---- embeddings / unembedding: vocab on model
        if ps.endswith("embed/table"):
            return (pol.model, None) if div(0) else (None, None)
        if "lm_head" in ps:
            return _wspec(pol, rank, 1, leaf, rank - 2) if div(rank - 1) else none
        # ---- MoE experts: [E, D, F] (JAX: [L, E, D, F])
        if "/experts/" in ps or ps.startswith("experts/"):
            E = leaf.shape[rank - 3]
            if pol.shard_experts and E % max(m_size, 1) == 0:
                spec = [None] * rank
                spec[rank - 3] = pol.model          # expert dim
                if pol.expert_2d:
                    d_size = pol.axis_size(pol.data)
                    ff_dim = rank - 1 if not ps.endswith("down/w") else rank - 2
                    if d_size > 1 and leaf.shape[ff_dim] % d_size == 0:
                        spec[ff_dim] = pol.data     # 2D expert sharding
                return tuple(spec)
            shard_dim = 0 if ps.endswith("down/w") else 1
            return _wspec(pol, rank, shard_dim, leaf, rank - 2)
        if "router" in ps:
            return none
        # ---- attention
        if any(ps.endswith(f"{n}/w") for n in ("q", "k", "v")) or "/in_" in ps \
                or ps.endswith("in_proj/w"):
            return _wspec(pol, rank, 1, leaf, rank - 2) if div(rank - 1) else none
        if ps.endswith("o/w") or ps.endswith("out/w") or ps.endswith("out_proj/w"):
            return _wspec(pol, rank, 0, leaf, rank - 2) if div(rank - 2) else none
        # ---- mlp
        if ps.endswith("gate/w") or ps.endswith("up/w") or ps.endswith("fc1/w"):
            return _wspec(pol, rank, 1, leaf, rank - 2) if div(rank - 1) else none
        if ps.endswith("down/w") or ps.endswith("fc2/w"):
            return _wspec(pol, rank, 0, leaf, rank - 2) if div(rank - 2) else none
        # ---- hybrid gates (w x w): shard output
        if ps.endswith("gate_r/w") or ps.endswith("gate_i/w"):
            return _wspec(pol, rank, 1, leaf, rank - 2) if div(rank - 1) else none
        # ---- everything else (norms, biases, conv, scalars): replicated
        return none

    return map_with_path(rule, params_shape)


def cache_specs(cfg, cache_shape, pol: ShardingPolicy, batch: int,
                shard_seq: bool = True):
    """KV/state caches: batch on data when divisible.

    KV ring buffers [L, B, W, Kv, D] additionally shard the sequence axis W
    on the model axis when divisible (JAX's sequence-parallel cache). The
    port's own tensor-parallel cache is head-sharded instead
    (``parallel.tp``; ROADMAP.md's deliberate differences); the spec is
    JAX's, for the dry run's per-device bytes and the parity tests."""
    b_ax = pol.batch_axis(batch)
    m_size = pol.axis_size(pol.model)

    def rule(path, leaf):
        rank = len(leaf.shape)
        if rank == 0:
            return ()
        spec = [None] * rank
        # batch dim position is structural: hybrid "tail" caches are unstacked
        # ([B, ...]); every other cache carries a leading layer/block stack
        # ([L, B, ...]). Never guess by size — L can collide with B.
        bdim = 0 if "tail" in path else 1
        if bdim < rank and leaf.shape[bdim] == batch:
            spec[bdim] = b_ax
        key = path.split("/")[-1]
        if shard_seq and key in ("k", "v") and rank == 5 and m_size > 1:
            if b_ax is None:
                # batch replicated (2D-TP serving): spread W over EVERY axis
                d_names = (() if pol.data is None else
                           ((pol.data,) if isinstance(pol.data, str) else tuple(pol.data)))
                m_names = ((pol.model,) if isinstance(pol.model, str)
                           else tuple(pol.model))
                full = d_names + m_names
                sz = pol.axis_size(pol.data) * m_size
                if leaf.shape[2] % sz == 0:
                    spec[2] = full
                elif leaf.shape[2] % m_size == 0:
                    spec[2] = pol.model
            elif leaf.shape[2] % m_size == 0:
                spec[2] = pol.model
        return tuple(spec)

    return map_with_path(rule, cache_shape)


def io_specs(pol: ShardingPolicy, batch: int):
    """(tokens_spec, logits_spec) for step functions."""
    b_ax = pol.batch_axis(batch)
    return (b_ax, None), (b_ax, None, pol.model)


# ---------------------------------------------------------------------------
# spec tree -> per-device slices (the counterpart of JAX's ns_tree/sds_with)
# ---------------------------------------------------------------------------
def axis_names(entry) -> tuple:
    """The axis names a spec entry (or a policy's axis) names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_coords(axes, sizes) -> list:
    """Each device's coordinates {axis: i} in mesh order (row-major over
    ``axes``, as JAX's mesh of ``devices.reshape(sizes)`` lays them)."""
    return [dict(zip(axes, c)) for c in np.ndindex(*tuple(sizes))]


def shard_index(entry, coords, sizes_by_axis) -> tuple:
    """(index, count) of the piece a device at ``coords`` holds of a dim
    whose spec entry is ``entry``: the axes of a tuple entry split it
    major to minor."""
    idx, count = 0, 1
    for a in axis_names(entry):
        idx = idx * sizes_by_axis[a] + coords[a]
        count *= sizes_by_axis[a]
    return idx, count


class LeafPlan(NamedTuple):
    """Where one leaf's pieces live: ``local`` is the per-device shape,
    ``slices[j]`` the global slice (a tuple of ``slice`` per dim) that
    device j of the submesh (mesh order) holds."""
    spec: tuple
    local: tuple
    slices: tuple


def leaf_plan(spec, shape, axes, sizes) -> LeafPlan:
    """The per-device slices of a leaf of ``shape`` under ``spec`` on a
    submesh of ``axes``/``sizes``. A dim whose axes do not divide it is an
    error here (the spec builders shard only dims they divide)."""
    by_axis = dict(zip(axes, sizes))
    local = list(shape)
    for d, entry in enumerate(spec):
        _, count = shard_index(entry, {a: 0 for a in by_axis}, by_axis)
        if shape[d] % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry!r} ({count})")
        local[d] = shape[d] // count
    slices = []
    for coords in mesh_coords(axes, sizes):
        sl = []
        for d, entry in enumerate(spec):
            i, _ = shard_index(entry, coords, by_axis)
            sl.append(slice(i * local[d], (i + 1) * local[d]))
        slices.append(tuple(sl))
    return LeafPlan(tuple(spec), tuple(local), tuple(slices))


def zip_with_path(fn, spec_tree, tree, path=""):
    """``fn(path, spec, leaf)`` over the array leaves of ``tree`` and the
    matching specs of ``spec_tree`` (paths as ``map_with_path``'s)."""
    if isinstance(tree, dict):
        return {k: zip_with_path(fn, spec_tree[k], v,
                                 f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [zip_with_path(fn, s, v, f"{path}/{i}" if path else str(i))
                for i, (s, v) in enumerate(zip(spec_tree, tree))]
    return fn(path, spec_tree, tree) if _is_leaf(tree) else None


def shard_plan(spec_tree, shape_tree, axes, sizes):
    """Spec tree + shape tree -> a ``LeafPlan`` per leaf on the submesh
    ``axes``/``sizes`` (JAX's ``ns_tree``: which slice each device of the
    submesh holds)."""
    return zip_with_path(
        lambda _, s, leaf: leaf_plan(s, tuple(leaf.shape), axes, sizes),
        spec_tree, shape_tree)


def local_shape(shape, spec, pol: ShardingPolicy) -> tuple:
    """The shape one device holds of a leaf of ``shape`` under ``spec``: a
    dim divided by the size of the axes its entry names."""
    return tuple(n // pol.axis_size(e) if e is not None else n
                 for n, e in zip(shape, spec))


def local_shapes(spec_tree, shape_tree, pol: ShardingPolicy):
    """Each leaf's per-device shape under ``spec_tree`` (JAX's
    ``sds_with``, read for the shapes a device holds)."""
    return zip_with_path(lambda _, spec, leaf: local_shape(leaf.shape, spec, pol),
                         spec_tree, shape_tree)
