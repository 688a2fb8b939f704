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
  * transfers: ``put`` moves a tree's tensors onto the role's (first)
    device, ``put_params``/``put_cache`` place a role's params and cache
    (split over a tensor-parallel role's devices, below), and
    ``Placement.to_target``/``to_drafter`` carry the gamma-token
    draft/verify handoff across (the only data that crosses roles each
    round, the paper's tiny PU-to-PU exchange).

The visible devices are a list, ``[cuda:0, cuda:1, ...]`` by default
(``device.visible``: no visible GPU raises; nothing falls back to the CPU
quietly), and an entry is known by its position in it: ``disjoint``
compares positions and ``describe()`` prints them where JAX prints device
ids, so a list of eight ``torch.device("cpu")`` entries stands in for JAX's
eight host devices.

A role with a model axis larger than 1 is tensor-parallel when its model
is of the dense family (``parallel.tp``): ``put_params`` splits the params
by JAX's ``param_specs`` (derived once per config, as JAX memoizes its
shardings) over the devices of the model axis (the first replica of any
data axis), its caches are made split by KV heads (``layout``; the
engines split the params before the prefill, so no forward of the role
runs unsplit), and every forward runs on all of them, the logits gathered
on the role's first device. A
split the heads do not allow raises ``PlacementError``; nothing falls
back. Other roles run on their first device, and ``note`` says so: a role
whose only axes are data axes (its batch is not split), and a role whose
model is of a family this port does not shard (moe, hybrid, ssm, vlm,
encdec). ``describe()`` adds each sharded role's layout (heads a device,
KV split or replicated) once ``put_params`` has made it. No run has
spanned two CUDA devices: on one H100 a role's entries are all
``cuda:0`` and the same code runs each shard in turn there.

Identical drafter/target submeshes (the default replicated plan) lower to
the DEGENERATE placement: no devices, and every helper is the identity
(the same objects come back), so execution is the unplaced stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devices_mod
from repro_torch.api.plan import PlacementPlan, SubmeshSpec
from repro_torch.models.specs import ShardingPolicy, param_specs
from repro_torch.parallel import tp

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
        """The role's first device, where its tokens, logits and shared
        cache leaves live (None when degenerate)."""
        return self.devices[0] if self.devices else None

    @property
    def model_positions(self) -> tuple:
        """The positions of the role's model axis: the devices whose
        coordinates on every data axis are 0, in mesh order (the model
        axes' shard order)."""
        if not self.devices or not self.spec.axes:
            return self.positions[:1]
        grid = np.arange(len(self.positions)).reshape(self.spec.sizes)
        at = tuple(0 if a in DATA_AXES else slice(None) for a in self.spec.axes)
        return tuple(self.positions[j] for j in grid[at].reshape(-1))

    @property
    def tensor_parallel(self) -> bool:
        """True when the role has a model axis larger than 1."""
        return self.policy.axis_size(self.policy.model) > 1

    def _memo(self, name):
        # frozen dataclass: memos go in through object.__setattr__, as
        # JAX's RolePlacement memoizes its shardings
        memo = self.__dict__.get(name)
        if memo is None:
            memo = {}
            object.__setattr__(self, name, memo)
        return memo

    def layout(self, model) -> Optional[tp.TPLayout]:
        """The tensor-parallel layout of ``model`` on this role (memoized
        per config); None when the role runs on its first device (no model
        axis, or a family this port does not shard). Raises PlacementError
        when the heads do not split over the model axis."""
        if not self.devices or not self.tensor_parallel \
                or model.family != "dense":
            return None
        memo = self._memo("_layouts")
        if model.cfg not in memo:
            pos = self.model_positions
            devs = tuple(self.devices[self.positions.index(p)] for p in pos)
            try:
                memo[model.cfg] = tp.make_layout(model.cfg, self.spec.name,
                                                 devs, pos)
            except ValueError as e:
                raise PlacementError(str(e)) from None
        return memo[model.cfg]

    def param_specs(self, model, params):
        """JAX's ``param_specs`` of ``model`` over this role's policy,
        memoized per config (shardings are a pure function of the config
        and the policy)."""
        memo = self._memo("_param_specs")
        if model.cfg not in memo:
            memo[model.cfg] = param_specs(model.cfg, params, self.policy)
        return memo[model.cfg]

    # ------------------------------------------------------------- transfers
    def put(self, tree):
        """Move a (small) tree onto this role's first device — the
        cross-role handoff primitive. Identity when degenerate."""
        if not self.devices or tree is None:
            return tree
        return tree_to(tree, self.device)

    def put_params(self, model, params):
        """Pin a role's params: split over its model axis when the role is
        tensor-parallel for ``model``, else moved to its first device. A
        split is a snapshot: every piece is a copy, made at the first call
        for a record and returned again for the same record (the memo
        holds the last record and its split), so a caller that updates its
        params in place passes them again as a new record. A record
        already split is taken as it is."""
        lay = self.layout(model)
        if lay is None:
            return self.put(params)
        if isinstance(params, tp.TPParams):
            if params.layout != lay:
                raise PlacementError(f"params split for {params.layout.name}, "
                                     f"not {lay.name}")
            return params
        last = self._memo("_last_params")
        if last.get("src") is not params:
            try:
                split = tp.shard_params(params, lay,
                                        self.param_specs(model, params),
                                        self.policy)
            except ValueError as e:
                raise PlacementError(str(e)) from None
            last.update(src=params, out=split)
        return last["out"]

    def put_cache(self, model, cache, batch: int):
        """A role's cache on its devices. A tensor-parallel role's cache is
        made split by its layout (``init_cache``/``init_paged_cache`` with
        ``layout=self.layout(model)``, or a prefill with split params):
        its pieces are checked against the layout and its shared leaves
        move to the first device; anything else raises PlacementError.
        Any other role's cache moves to its first device."""
        lay = self.layout(model) if model is not None else None
        if lay is None or cache is None:
            return self.put(cache)
        try:
            return tp.place_cache(cache, lay)
        except ValueError as e:
            raise PlacementError(str(e)) from None

    def describe_layouts(self) -> list:
        """Each tensor-parallel layout made on this role so far."""
        return [lay.describe()
                for lay in self.__dict__.get("_layouts", {}).values()]


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
        layouts = self.drafter.describe_layouts() + self.target.describe_layouts()
        return (f"placement: drafter@{one(self.drafter)} "
                f"target@{one(self.target)} ({kind}"
                f"{', overlap-dispatch' if self.overlap else ''})"
                f"{' — ' + self.note if self.note else ''}"
                + "".join(f"; {d}" for d in layouts))


DEGENERATE = Placement(drafter=RolePlacement(SubmeshSpec()),
                       target=RolePlacement(SubmeshSpec()))


UNSHARDED_FAMILIES = ("moe", "hybrid", "ssm", "vlm", "encdec")


def _role_note(*roles: RolePlacement) -> str:
    """What the note says of roles of several devices: a role with a model
    axis is tensor-parallel over it for dense models (other families run
    on its first device); a role of data axes only runs on its first."""
    tp_roles, first = [], []
    for r in roles:
        if len(r.positions) < 2:
            continue
        if r.tensor_parallel:
            pos = r.model_positions
            tp_roles.append(f"{r.spec.name} over devices "
                            f"{','.join(map(str, pos))}"
                            + (" (one replica of its data axes)"
                               if len(pos) < len(r.positions) else ""))
        else:
            first.append(f"{r.spec.name} on device {r.positions[0]} of "
                         f"{len(r.positions)} (data axes only)")
    out = []
    if tp_roles:
        out.append("tensor parallel: " + ", ".join(tp_roles)
                   + f" (dense family; {', '.join(UNSHARDED_FAMILIES)} "
                   "models run on the role's first device)")
    if first:
        out.append("no batch split: " + ", ".join(first)
                   + " (runs on its first)")
    return "; ".join(out)


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
    extra = _role_note(drafter, target)
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
