"""TPU-pod sub-slice partition FSM — the hardware adaptation of MIG; the
port's copy of ``repro.core.tpu_slices``.  Host code: the fleet's device
catalogue models a TPU pod with it, and nothing here touches a device.

A v5e pod is a 16x16 chip mesh (256 chips, 16GB HBM each).  Valid sub-slices
are the rectangles produced by recursively halving the longer dimension
(buddy decomposition), mirroring how MIG only allows profiles at fixed slice
starts:

    depth  shape   chips   HBM
      0    16x16    256   4096GB
      1     8x16    128   2048GB
      2     8x8      64   1024GB
      3     4x8      32    512GB
      4     4x4      16    256GB
      5     2x4       8    128GB
      6     2x2       4     64GB
      7     1x2       2     32GB
      8     1x1       1     16GB

A state is a binary buddy tree: each node is FREE, ALLOCATED, or SPLIT into
two children.  ``alloc(depth d)`` = pick a FREE node at depth <= d and split
down to depth d; ``free`` = mark ALLOCATED -> FREE and coalesce FREE buddies.

Reachability (|F_s|, paper §4.2) in closed form
-----------------------------------------------
Let f(d) = number of fully configured states of a free node at depth d
(max depth D = 8).  A full configuration either allocates the node whole or
splits it and fully configures both children:

    f(D) = 1,      f(d) = 1 + f(d+1)^2

Then |F_s| = prod over FREE nodes n of f(depth(n)) — allocated/split structure
is fixed, free nodes configure independently.  This evaluates Alg. 2's metric
exactly without enumerating the ~1.9e45 states.  (Python bignums handle the
magnitudes.)  A consequence the paper would appreciate: argmax-reachability
allocation degenerates to *best-fit* — split the smallest free node that fits
— because splitting a shallower node destroys more future configurations.
The generic Alg. 3 argmax below derives this rather than hard-coding it.
"""

from __future__ import annotations

import functools
from typing import Hashable

from repro_torch.core.partition_state import (PartitionBackend,
                                              PartitionProfile, Placement)

MAX_DEPTH = 8
POD_SHAPE = (16, 16)
CHIP_HBM_GB = 16.0


def shape_at_depth(depth: int, pod_shape: tuple[int, int] = POD_SHAPE
                   ) -> tuple[int, int]:
    x, y = pod_shape
    for _ in range(depth):
        if x >= y:
            x //= 2
        else:
            y //= 2
    return (x, y)


def chips_at_depth(depth: int, pod_shape: tuple[int, int] = POD_SHAPE
                   ) -> int:
    x, y = shape_at_depth(depth, pod_shape)
    return x * y


@functools.lru_cache(maxsize=None)
def f_configs(depth: int) -> int:
    """Number of fully configured states of a FREE node at ``depth``."""
    if depth >= MAX_DEPTH:
        return 1
    return 1 + f_configs(depth + 1) ** 2


# -- state encoding ----------------------------------------------------------
# A node is encoded as a nested tuple:
#   'F'          free
#   'A'          allocated (one partition covering this node)
#   ('S', l, r)  split
# States are hashable and canonical (free buddies are always coalesced).

FREE = "F"
ALLOC = "A"


def _coalesce(node):
    if isinstance(node, tuple):
        l, r = _coalesce(node[1]), _coalesce(node[2])
        if l == FREE and r == FREE:
            return FREE
        return ("S", l, r)
    return node


class TpuPodBackend(PartitionBackend):
    """Buddy sub-slice FSM over one 16x16 v5e pod."""

    def __init__(self, max_depth: int = MAX_DEPTH,
                 pod_shape: tuple[int, int] = POD_SHAPE,
                 chip_hbm_gb: float = CHIP_HBM_GB) -> None:
        self.max_depth = max_depth
        self.pod_shape = pod_shape
        self.chip_hbm_gb = chip_hbm_gb
        def sh(d):
            return shape_at_depth(d, pod_shape)

        def ch(d):
            return chips_at_depth(d, pod_shape)

        self.profiles = [
            PartitionProfile(
                name="x".join(map(str, sh(d))),
                mem_gb=ch(d) * chip_hbm_gb,
                compute_fraction=ch(d) / ch(0),
                extent=ch(d))
            for d in range(max_depth, -1, -1)  # increasing memory order
        ]
        self._depth_by_name = {
            "x".join(map(str, sh(d))): d for d in range(max_depth + 1)}

    # -- FSM ---------------------------------------------------------------

    def initial_state(self) -> Hashable:
        return FREE

    def profile_depth(self, profile: PartitionProfile) -> int:
        return self._depth_by_name[profile.name]

    def enumerate_placements(self, state: Hashable, profile: PartitionProfile
                             ) -> list[Placement]:
        target = self.profile_depth(profile)
        placements: list[Placement] = []

        def walk(node, depth, path):
            if node == ALLOC:
                return
            if node == FREE:
                if depth == target:
                    placements.append(Placement(
                        profile=profile, handle=path,
                        next_state=self._replace(state, path, ALLOC)))
                elif depth < target:
                    # split down: both child paths are symmetric in shape but
                    # are distinct placements (Alg. 3 enumerates them all).
                    walk_split_free(depth, path)
                return
            _tag, l, r = node
            walk(l, depth + 1, path + (0,))
            walk(r, depth + 1, path + (1,))

        def walk_split_free(depth, path):
            # a FREE node above target depth: enumerate every leaf position
            # at target depth below it.
            if depth == target:
                placements.append(Placement(
                    profile=profile, handle=path,
                    next_state=self._replace(state, path, ALLOC)))
                return
            for side in (0, 1):
                walk_split_free(depth + 1, path + (side,))

        walk(state, 0, ())
        return placements

    def _replace(self, state, path, value):
        """Return state with the node at ``path`` set to ``value``; splits
        FREE ancestors on the way down; coalesces afterwards."""

        def rec(node, depth, path):
            if not path:
                return value
            if node == FREE:
                node = ("S", FREE, FREE)
            if node == ALLOC:
                raise ValueError("cannot descend into an allocated node")
            _tag, l, r = node
            if path[0] == 0:
                return ("S", rec(l, depth + 1, path[1:]), r)
            return ("S", l, rec(r, depth + 1, path[1:]))

        return _coalesce(rec(state, 0, tuple(path)))

    def free(self, state: Hashable, handle: Hashable) -> Hashable:
        # verify handle points at an ALLOC node
        node = state
        for side in handle:
            if node in (FREE, ALLOC):
                raise KeyError(f"no allocated node at {handle}")
            node = node[1 + side]
        if node != ALLOC:
            raise KeyError(f"node at {handle} is not allocated")
        return self._replace_allocated(state, tuple(handle))

    def _replace_allocated(self, state, path):
        def rec(node, path):
            if not path:
                return FREE
            _tag, l, r = node
            if path[0] == 0:
                return ("S", rec(l, path[1:]), r)
            return ("S", l, rec(r, path[1:]))

        return _coalesce(rec(state, path))

    def reachability(self, state: Hashable) -> int:
        """|F_s| via the closed-form product over free nodes."""

        def rec(node, depth):
            if node == FREE:
                # f_configs is indexed by levels-remaining in a MAX_DEPTH
                # tree; shift for backends with a shallower max_depth.
                return f_configs(MAX_DEPTH - self.max_depth + depth)
            if node == ALLOC:
                return 1
            _tag, l, r = node
            return rec(l, depth + 1) * rec(r, depth + 1)

        return rec(state, 0)

    def total_mem_gb(self) -> float:
        return chips_at_depth(0, self.pod_shape) * self.chip_hbm_gb

    # -- TPU-facing helpers --------------------------------------------------

    def slice_shape(self, handle) -> tuple[int, int]:
        return shape_at_depth(len(handle), self.pod_shape)

    def slice_origin(self, handle) -> tuple[int, int]:
        """Grid origin of the slice — maps a buddy path to device coords."""
        x0, y0 = 0, 0
        x, y = self.pod_shape
        for side in handle:
            if x >= y:
                x //= 2
                x0 += side * x
            else:
                y //= 2
                y0 += side * y
        return (x0, y0)

    def describe(self, state: Hashable) -> str:
        parts: list[str] = []

        def rec(node, depth, path):
            if node == ALLOC:
                sx, sy = shape_at_depth(depth, self.pod_shape)
                parts.append(f"{sx}x{sy}@{self.slice_origin(path)}")
            elif isinstance(node, tuple):
                rec(node[1], depth + 1, path + (0,))
                rec(node[2], depth + 1, path + (1,))

        rec(state, 0, ())
        empty = "x".join(map(str, self.pod_shape)) + "-free"
        return "(" + ", ".join(parts or [empty]) + ")"


@functools.lru_cache(maxsize=1)
def make_backend() -> TpuPodBackend:
    return TpuPodBackend()
