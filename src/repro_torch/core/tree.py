"""Token-tree topology for tree speculation (port of ``repro/core/tree.py``;
numpy only, a copy kept so that the port never imports ``repro``).

A speculation tree is a set of draft nodes hanging off the last committed
token (the *root*). The verify pass packs the root plus every node into one
flat span of query slots:

    slot 0              -> t_last (the root, depth 0)
    slot 1 .. n_nodes   -> draft nodes, any topological order (parent < child)

Each slot carries two static attributes the attention mask needs:

  * ``depths[s]``  — distance from the root; the RoPE position of slot ``s``
    is ``index + depths[s]`` where ``index`` is the root's cache position, so
    committing a root-to-leaf path by compaction leaves correct baked-in
    K positions behind.
  * ``bits[s]``    — an int32 ancestor bitmask (bit ``t`` set iff slot ``t``
    is ``s`` or an ancestor of ``s``). A query slot may attend an in-span
    KV slot only along its own root path; everything before the span is
    ordinary causal prefix. The bitmask caps the span at 31 slots so it
    never touches the int32 sign bit.

Rounds use *chain* trees — ``width`` independent chains of ``depth`` tokens
branching once at the root (``chain_tree``). The mask and kernel layer is
topology-agnostic: any parent array with ``parents[i] < i + 1`` works.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

MAX_SPAN = 31  # ancestor masks live in int32; bit 31 is the sign bit


@dataclasses.dataclass(frozen=True)
class TreeShape:
    """Static topology of one speculation tree.

    ``parents[i]`` is the parent *slot* of node slot ``i + 1`` (slot 0 is the
    root). Node slots must be topologically ordered: ``parents[i] < i + 1``.
    """

    parents: tuple

    def __post_init__(self):
        for i, p in enumerate(self.parents):
            if not 0 <= p < i + 1:
                raise ValueError(
                    f"node slot {i + 1} has parent {p}; parents must satisfy "
                    "0 <= parent < slot (topological slot order)")
        if self.span > MAX_SPAN:
            raise ValueError(
                f"tree span {self.span} exceeds {MAX_SPAN} (int32 ancestor "
                "bitmask); shrink width*depth")

    @property
    def n_nodes(self):
        return len(self.parents)

    @property
    def span(self):
        """Query slots in one stacked verify pass: root + all nodes."""
        return self.n_nodes + 1

    @functools.cached_property
    def depths(self):
        """int32 [span]: distance of each slot from the root (root = 0)."""
        d = np.zeros(self.span, np.int32)
        for i, p in enumerate(self.parents):
            d[i + 1] = d[p] + 1
        return d

    @functools.cached_property
    def bits(self):
        """int32 [span]: ancestor bitmask per slot, self-inclusive."""
        b = np.zeros(self.span, np.int32)
        b[0] = 1
        for i, p in enumerate(self.parents):
            b[i + 1] = b[p] | np.int32(1 << (i + 1))
        return b

    @functools.cached_property
    def leaves(self):
        has_child = np.zeros(self.span, bool)
        for p in self.parents:
            has_child[p] = True
        return tuple(s for s in range(1, self.span) if not has_child[s])

    @functools.cached_property
    def paths(self):
        """One root-to-leaf slot path per leaf (root slot 0 excluded)."""
        out = []
        for leaf in self.leaves:
            path, s = [], leaf
            while s != 0:
                path.append(s)
                s = self.parents[s - 1]
            out.append(tuple(reversed(path)))
        return tuple(out)

    @property
    def max_depth(self):
        return int(self.depths.max()) if self.n_nodes else 0


@dataclasses.dataclass(frozen=True)
class ChainTree(TreeShape):
    """``width`` chains of ``depth`` nodes branching once at the root.

    Slots are level-major: level ``l`` (1-based), chain ``p`` sits at slot
    ``1 + (l - 1) * width + p`` — so drafting level ``l`` for all chains is
    one batched drafter step over ``batch * width`` rows.
    """

    width: int = 1
    depth: int = 1

    @functools.cached_property
    def chain_slots(self):
        """int32 [width, depth]: slot of (chain p, level l)."""
        w, d = self.width, self.depth
        return np.asarray(
            [[1 + le * w + p for le in range(d)] for p in range(w)], np.int32)


def chain_tree(width, depth):
    if width < 1 or depth < 1:
        raise ValueError(f"chain tree needs width, depth >= 1 "
                         f"(got {width}x{depth})")
    parents = []
    for level in range(1, depth + 1):
        for p in range(width):
            parents.append(0 if level == 1 else 1 + (level - 2) * width + p)
    return ChainTree(parents=tuple(parents), width=width, depth=depth)


def linear_span_bits(span):
    """Ancestor masks of a single chain (the degenerate width-1 tree)."""
    return chain_tree(1, span - 1).bits if span > 1 else np.ones(1, np.int32)
