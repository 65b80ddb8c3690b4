"""Generic contiguous-span MIG partition FSM.

Every MIG-capable NVIDIA part (A30, A100, H100, H200 — the Ampere/Hopper
line the paper's abstract targets) exposes the same structure: ``n_gpc``
compute slices, ``n_mem_slices`` memory slices, and a table of profiles that
occupy a contiguous GPC span and may only *start* at hardware-defined
positions, so each device is one table (the port carries the H100's,
:mod:`repro_torch.core.mig_h100`, and the A100's,
:mod:`repro_torch.core.mig_a100`).  This is the port's copy of
``repro.core.mig_span``.

A state is the frozenset of (start_gpc, profile_name) instances;
``delta`` is well-defined because start positions are explicit.
"""

from __future__ import annotations

from typing import Hashable, Mapping

from repro_torch.core.partition_state import (PartitionBackend,
                                              PartitionProfile, Placement)

#: profile name -> (gpc span, memory slices, allowed start GPCs)
ProfileTable = Mapping[str, tuple[int, int, tuple[int, ...]]]


class MigSpanBackend(PartitionBackend):
    """Span-FSM over one device described by a profile table."""

    #: every MIG part's FSM is small (A100: 308 states, H100: ~1.1k) —
    #: compile it (planner/graph.py) so hot allocations are dict lookups.
    supports_compiled_graph = True

    def __init__(self, device_name: str, table: ProfileTable, n_gpc: int,
                 n_mem_slices: int, mem_slice_gb: float) -> None:
        self.device_name = device_name
        self.table = dict(table)
        self.n_gpc = n_gpc
        self.n_mem_slices = n_mem_slices
        self.mem_slice_gb = mem_slice_gb
        self.profiles = sorted(
            (PartitionProfile(name=name,
                              mem_gb=mem * mem_slice_gb,
                              compute_fraction=gpcs / n_gpc,
                              extent=gpcs)
             for name, (gpcs, mem, _starts) in self.table.items()),
            key=lambda p: (p.mem_gb, p.compute_fraction))
        self._by_name = {p.name: p for p in self.profiles}

    # -- reachability cache identity ---------------------------------------
    # precompute_reachability memoizes per backend; a value-based key lets
    # every equivalent instance (e.g. per-test fixtures) share one table and
    # is immune to id() reuse after garbage collection.

    def reachability_cache_key(self) -> Hashable:
        return (type(self).__name__, self.device_name, self.n_gpc,
                self.n_mem_slices, self.mem_slice_gb,
                tuple(sorted((n, v) for n, v in self.table.items())))

    # -- FSM ---------------------------------------------------------------

    def initial_state(self) -> Hashable:
        return frozenset()

    def _occupied_gpcs(self, state: frozenset) -> set[int]:
        occ: set[int] = set()
        for start, name in state:
            span = self.table[name][0]
            occ.update(range(start, start + span))
        return occ

    def _used_mem_slices(self, state: frozenset) -> int:
        return sum(self.table[name][1] for _s, name in state)

    def enumerate_placements(self, state: Hashable, profile: PartitionProfile
                             ) -> list[Placement]:
        state = frozenset(state)
        gpcs, mem, starts = self.table[profile.name]
        if self._used_mem_slices(state) + mem > self.n_mem_slices:
            return []
        occupied = self._occupied_gpcs(state)
        placements = []
        for start in starts:
            span = set(range(start, start + gpcs))
            if span & occupied or start + gpcs > self.n_gpc:
                continue
            nxt = frozenset(state | {(start, profile.name)})
            placements.append(Placement(profile=profile,
                                        handle=(start, profile.name),
                                        next_state=nxt))
        return placements

    def free(self, state: Hashable, handle: Hashable) -> Hashable:
        state = frozenset(state)
        if handle not in state:
            raise KeyError(f"partition {handle} not in state {state}")
        return frozenset(state - {handle})

    def reachability(self, state: Hashable) -> int:
        from repro_torch.core.reachability import precompute_reachability
        fcr = precompute_reachability(self)
        return fcr[frozenset(state)]

    def total_mem_gb(self) -> float:
        return self.n_mem_slices * self.mem_slice_gb

    # -- paper-facing helpers ----------------------------------------------

    def describe(self, state: Hashable) -> str:
        """Render a state in the paper's '(5GB, 5GB, 30GB-unallocated)' form."""
        state = frozenset(state)
        parts = [f"{self.table[name][1] * self.mem_slice_gb:.0f}GB@gpc{start}"
                 for start, name in sorted(state)]
        free_gb = self.total_mem_gb() - sum(
            self.table[name][1] * self.mem_slice_gb for _s, name in state)
        parts.append(f"{free_gb:.0f}GB-unallocated")
        return "(" + ", ".join(parts) + ")"
