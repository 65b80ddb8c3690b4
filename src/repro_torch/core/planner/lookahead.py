"""k-step plan-ahead carving over the compiled transition graph (the port's
copy of ``repro.core.planner.lookahead``).

The batch policies' homogeneous-slice carve (scheme A's
SET_HOMOGENEOUS_SLICES) is greedy: take the argmax-|F_s| placement one
slice at a time until the device refuses.  Greedy is optimal per step but
not per *sequence* — an early placement can orphan span that a different
first move would have kept carvable ("Optimal Workload Placement on
Multi-Instance GPUs", arXiv:2409.06646, motivates exactly this
look-ahead).  With the FSM compiled, every ``(state, profile)``
transition is an O(1) dictionary lookup, so a bounded beam over placement
*chains* costs microseconds on the MIG backends.

The guarantee is structural, not empirical: the
greedy chain is always evaluated as a candidate and the beam's winner
must score strictly higher on ``(slices, total compute, final |F_s|)``
to replace it — plan-ahead can therefore never carve fewer or weaker
slices than the greedy loop.  Backends without a compiled graph fall
back to the greedy chain unchanged.
"""

from __future__ import annotations

import math
from typing import Hashable, Sequence

from repro_torch.core.partition_manager import Partition, PartitionManager
from repro_torch.core.partition_state import PartitionProfile, Placement

#: Chains kept per depth.  The MIG FSMs are small (A100: 308 states) and
#: a device holds at most 7 slices, so a narrow beam already covers every
#: distinct reachable end-state that matters; raising this past ~16 only
#: re-discovers permutations of the same placements.
DEFAULT_BEAM_WIDTH = 8


def _chain_score(pm: PartitionManager, chain: tuple[Placement, ...],
                 state: Hashable) -> tuple[float, float, float]:
    """Lexicographic value of a finished carve: slice count, then summed
    compute fraction (the batch-throughput proxy scheme A maximizes),
    then the end state's |F_s| (leave the device most reconfigurable)."""
    compute = sum(p.profile.compute_fraction for p in chain)
    if not math.isfinite(compute):
        bad = [p.profile.name for p in chain
               if not math.isfinite(p.profile.compute_fraction)]
        raise ValueError(
            f"non-finite compute_fraction in carve chain (profiles {bad}): "
            f"chain scores would compare order-dependently")
    return (float(len(chain)), compute, float(pm.reach(state)))


def _greedy_chain(pm: PartitionManager, state: Hashable,
                  profiles: Sequence[PartitionProfile]
                  ) -> tuple[Placement, ...]:
    """The exact chain the legacy ``pm.allocate`` loop would commit: first
    profile (in preference order) with a feasible argmax-|F_s| placement,
    repeated until nothing fits.  Evaluated hypothetically — nothing is
    committed."""
    chain: list[Placement] = []
    while True:
        placement = None
        for prof in profiles:
            placement = pm.best_placement(state, prof)
            if placement is not None:
                break
        if placement is None:
            return tuple(chain)
        chain.append(placement)
        state = placement.next_state


def plan_carve(pm: PartitionManager,
               profiles: Sequence[PartitionProfile],
               beam_width: int = DEFAULT_BEAM_WIDTH
               ) -> tuple[Placement, ...]:
    """The placement chain a maximal homogeneous carve should commit.

    Runs the greedy chain, then (on compiled backends) a beam of width
    ``beam_width`` over the transition graph's placement lists, keeping
    the best-scoring chain per distinct reached state at each depth.
    Growing a chain never lowers its score (every profile has positive
    compute), so only *terminal* chains — states where no profile fits —
    compete, and the greedy chain wins all ties.  Pure planning: the
    manager's live state is untouched.
    """
    start: Hashable = pm.state
    greedy = _greedy_chain(pm, start, profiles)
    graph = pm.graph
    if graph is None or beam_width <= 1 or not profiles:
        return greedy
    end = greedy[-1].next_state if greedy else start
    best_chain, best_score = greedy, _chain_score(pm, greedy, end)
    # frontier maps reached state -> (chain, its score): the incumbent's
    # score is computed once when it enters the frontier, not re-derived
    # for every competing candidate (or again by the beam-prune sort)
    frontier: dict[Hashable, tuple[tuple[Placement, ...],
                                   tuple[float, float, float]]] = {
        start: ((), _chain_score(pm, (), start))}
    while frontier:
        nxt: dict[Hashable, tuple[tuple[Placement, ...],
                                  tuple[float, float, float]]] = {}
        for state, (chain, score) in frontier.items():
            terminal = True
            for prof in profiles:
                for pl in graph.placements(state, prof):
                    terminal = False
                    ns = pl.next_state
                    grown = chain + (pl,)
                    grown_score = _chain_score(pm, grown, ns)
                    prev = nxt.get(ns)
                    if prev is None or grown_score > prev[1]:
                        nxt[ns] = (grown, grown_score)
            if terminal and score > best_score:
                best_score, best_chain = score, chain
        if len(nxt) > beam_width:
            nxt = dict(sorted(nxt.items(), key=lambda kv: kv[1][1],
                              reverse=True)[:beam_width])
        frontier = nxt
    return best_chain


def carve_homogeneous(pm: PartitionManager,
                      profiles: Sequence[PartitionProfile],
                      beam_width: int = DEFAULT_BEAM_WIDTH
                      ) -> list[Partition]:
    """Plan (:func:`plan_carve`) and commit a maximal carve of ``profiles``
    slices, returning the live partitions in placement order.  Commit
    accounting matches the greedy loop exactly — one reconfiguration per
    slice — so swapping this in for a ``pm.allocate`` loop changes which
    placements are chosen, never how they are charged."""
    return [pm.commit_placement(pl)
            for pl in plan_carve(pm, profiles, beam_width)]
