"""Lowering layer: ``PlacementPlan`` -> one device set per role (port of
``repro/api/placement.py``).

The planner's decision ③ (core/partition.py DSE) records WHERE drafter and
target live as two ``SubmeshSpec``s. ``lower(plan.placement)`` makes it
real: a ``Placement`` with

  * one set of devices per role, carved out of the visible devices exactly
    as the JAX lowering carves its meshes (disjoint sets when both fit —
    the paper's drafter-PU/target-PU split; both from the front otherwise,
    the shared-PU fallback, recorded in ``note``);
  * a ``ShardingPolicy`` per role (submesh axes named ``data``/``pod``
    become the role's batch axes, everything else its tensor axes);
  * transfers: ``put``/``put_params``/``put_cache`` move a tree's tensors
    onto the role's device, and ``Placement.to_target``/``to_drafter``
    carry the gamma-token draft/verify handoff across (the only data that
    crosses roles each round, the paper's tiny PU-to-PU exchange).

The visible devices are a list, ``[cuda:0, cuda:1, ...]`` by default
(``device.visible``: no visible GPU raises; nothing falls back to the CPU
quietly), and an entry is known by its position in it: ``disjoint``
compares positions and ``describe()`` prints them where JAX prints device
ids, so a list of eight ``torch.device("cpu")`` entries stands in for JAX's
eight host devices.

A role of several devices runs on its first. JAX shards such a role's
params over its submesh (GSPMD); the port has no tensor parallelism across
CUDA devices yet (ROADMAP.md, Queue 1), so the carve and the policy are
recorded and ``note`` says which device runs the role. On one H100 no such
role arises: a ``DxT`` plan other than ``1x1`` needs more devices than are
visible and ``lower_or_degenerate`` falls back.

Identical drafter/target submeshes (the default replicated plan) lower to
the DEGENERATE placement: no devices, and every helper is the identity
(the same objects come back), so execution is the unplaced stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch import device as devices_mod
from repro_torch.api.plan import PlacementPlan, SubmeshSpec
from repro_torch.models.specs import ShardingPolicy

DATA_AXES = ("data", "pod")      # submesh axes that carry batch, not tensors


class PlacementError(ValueError):
    """The PlacementPlan cannot be realized on the visible devices."""


def tree_to(tree, device):
    """``tree`` with every tensor leaf moved to ``device`` (``.to``: a
    tensor already there comes back as itself); dicts, lists, tuples and
    NamedTuples are rebuilt, other leaves (keys, ints, None) pass as they
    are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


# -------------------------------------------------------------- role lowering
@dataclass(frozen=True)
class RolePlacement:
    """One partition's realized execution domain: its devices (entries of
    the visible list, at ``positions`` in it) and its sharding policy.

    No devices is the degenerate role (the caller's device); every helper
    is then the identity, so placed and unplaced code paths share one call
    shape."""
    spec: SubmeshSpec
    devices: tuple = ()
    positions: tuple = ()
    policy: ShardingPolicy = ShardingPolicy(data=None, model=None)

    @property
    def device(self) -> Optional[torch.device]:
        """The device the role runs on: its first (None when degenerate)."""
        return self.devices[0] if self.devices else None

    # ------------------------------------------------------------- transfers
    def put(self, tree):
        """Move a (small) tree onto this role's device — the cross-role
        handoff primitive. Identity when degenerate."""
        if not self.devices or tree is None:
            return tree
        return tree_to(tree, self.device)

    def put_params(self, model, params):
        """Pin a role's params onto its device."""
        return self.put(params)

    def put_cache(self, model, cache, batch: int):
        return self.put(cache)


def _role_policy(spec: SubmeshSpec) -> ShardingPolicy:
    data = tuple(a for a in spec.axes if a in DATA_AXES)
    model = tuple(a for a in spec.axes if a not in DATA_AXES)
    return ShardingPolicy(
        data=(data if len(data) > 1 else (data[0] if data else None)),
        model=(model if len(model) > 1 else (model[0] if model else None)),
        mesh_axis_sizes=dict(zip(spec.axes, spec.sizes)))


def _role_positions(spec: SubmeshSpec, positions: Sequence[int]) -> tuple:
    """The positions a role's mesh takes, as JAX's ``_role_mesh`` carves
    it: the first one for a replicated spec, else the first ``chips``."""
    if spec.chips > len(positions):
        raise PlacementError(
            f"submesh {spec.name!r} needs {spec.chips} devices, "
            f"{len(positions)} visible")
    return tuple(positions[:1] if not spec.axes else positions[:spec.chips])


def _role(spec: SubmeshSpec, positions: Sequence[int], visible) -> RolePlacement:
    pos = _role_positions(spec, positions)
    return RolePlacement(spec, tuple(visible[i] for i in pos), pos,
                         _role_policy(spec))


def _visible(devices: Optional[Sequence]) -> list:
    return list(devices_mod.visible() if devices is None else devices)


# ------------------------------------------------------------- the Placement
@dataclass(frozen=True)
class Placement:
    """Realized placement for one (drafter, target) deployment.

    ``heterogeneous`` placements carry devices for both roles; the
    degenerate lowering carries none and every helper is the identity, so
    callers thread one Placement object unconditionally.
    """
    drafter: RolePlacement
    target: RolePlacement
    overlap: bool = False              # dispatch next round before the host waits
    note: str = ""

    @property
    def heterogeneous(self) -> bool:
        return bool(self.drafter.devices) or bool(self.target.devices)

    @property
    def disjoint(self) -> bool:
        """True when drafter and target own non-overlapping device sets
        (positions in the visible list) — the paper's two-PU mapping."""
        d, t = set(self.drafter.positions), set(self.target.positions)
        return bool(d) and bool(t) and not (d & t)

    # ---------------------------------------------------- per-round handoffs
    def to_target(self, tree):
        """Move the gamma-token draft package onto the target's device."""
        return self.target.put(tree)

    def to_drafter(self, tree):
        """Move commit results (tokens/lengths) back to the drafter's."""
        return self.drafter.put(tree)

    def describe(self) -> str:
        if not self.heterogeneous:
            return ("placement: degenerate (single implicit mesh)"
                    + (f" — {self.note}" if self.note else ""))

        def one(r: RolePlacement):
            return (f"{r.spec.name}[{len(r.devices)} dev: "
                    f"{','.join(str(p) for p in r.positions)}]")
        kind = "disjoint" if self.disjoint else "overlapping"
        return (f"placement: drafter@{one(self.drafter)} "
                f"target@{one(self.target)} ({kind}"
                f"{', overlap-dispatch' if self.overlap else ''})"
                f"{' — ' + self.note if self.note else ''}")


DEGENERATE = Placement(drafter=RolePlacement(SubmeshSpec()),
                       target=RolePlacement(SubmeshSpec()))


def _first_device_note(*roles: RolePlacement) -> str:
    """What the note says of roles of several devices: each runs on its
    first (no tensor parallelism across CUDA devices)."""
    many = [f"{r.spec.name} on device {r.positions[0]} of {len(r.positions)}"
            for r in roles if len(r.positions) > 1]
    if not many:
        return ""
    return ("no tensor parallelism: " + ", ".join(many)
            + " (a role of several devices runs on its first)")


def lower(plan: PlacementPlan, devices: Optional[Sequence] = None) -> Placement:
    """Lower a PlacementPlan to per-role devices.

    Identical drafter/target submeshes (the default replicated plan) lower
    to DEGENERATE. Distinct submeshes get their own devices: disjoint sets
    when ``chips_d + chips_t`` fit the visible devices, else both carved
    from the front (shared-PU fallback, recorded in ``note``). Raises
    PlacementError when either submesh alone exceeds the devices.
    """
    if plan.drafter == plan.target:
        return DEGENERATE
    visible = _visible(devices)
    positions = list(range(len(visible)))
    cd, ct = plan.drafter.chips, plan.target.chips
    note = ""
    if cd + ct <= len(visible):
        d_pos, t_pos = positions[:cd], positions[cd:cd + ct]
    elif max(cd, ct) <= len(visible):
        d_pos = t_pos = positions
        note = (f"shared devices: {cd}+{ct} submesh chips > "
                f"{len(visible)} visible — roles overlap from device 0")
    else:
        raise PlacementError(
            f"placement needs {max(cd, ct)} devices for one role, "
            f"{len(visible)} visible")
    drafter = _role(plan.drafter, d_pos, visible)
    target = _role(plan.target, t_pos, visible)
    extra = _first_device_note(drafter, target)
    note = "; ".join(n for n in (note, extra) if n)
    return Placement(drafter=drafter, target=target,
                     overlap=getattr(plan, "overlap", False), note=note)


def role(spec: SubmeshSpec, devices: Optional[Sequence] = None) -> RolePlacement:
    """Lower ONE submesh to a RolePlacement (its own devices + policy)."""
    visible = _visible(devices)
    return _role(spec, list(range(len(visible))), visible)


def lower_or_degenerate(plan: PlacementPlan,
                        devices: Optional[Sequence] = None) -> Placement:
    """``lower`` with a graceful fallback: plans whose submeshes do not fit
    the visible devices (e.g. a 256-chip plan opened on one card) execute
    degenerately, with the reason recorded on the placement."""
    try:
        return lower(plan, devices)
    except PlacementError as e:
        return Placement(drafter=RolePlacement(plan.drafter),
                         target=RolePlacement(plan.target),
                         note=f"degenerate fallback: {e}")
