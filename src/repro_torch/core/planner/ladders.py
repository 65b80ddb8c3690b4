"""Candidate-profile ladders — the *order* in which the planner considers
partition sizes for a request (the port's copy of
``repro.core.planner.ladders``).

The paper's decision procedure shows up in three flavours that used to be
re-implemented per consumer: first placement of a job (scheme B / fleet
dispatch), growth of a live workload (serving-engine migration), and the
restart rungs after an OOM or an early-restart prediction (§2.3, §4.3;
the port's ``core/restart.py`` takes its targets from the last two).  All
three are ladder builders here; the planner scores the rungs with the
shared cost model.
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.core.partition_manager import Partition
from repro_torch.core.partition_state import (PartitionBackend,
                                              PartitionProfile)
from repro_torch.core.planner.planner import PlanRequest


def tight_profile(backend: PartitionBackend,
                  est_mem_gb: float | None) -> PartitionProfile:
    """Memory-only tightest fit; unknown memory starts on the smallest
    partition (paper §2.2), an over-large estimate on the largest."""
    if est_mem_gb is None:
        return backend.profiles[0]
    prof = backend.tightest_profile(est_mem_gb, compute=0.0)
    return prof if prof is not None else backend.profiles[-1]


def placement_ladder(backend: PartitionBackend, est_mem_gb: float | None,
                     compute_demand: float) -> list[PartitionProfile]:
    """Profiles to try for a fresh placement, preferred first: compute is a
    soft constraint (§4.3) — the profile covering the job's parallelism
    wins over memory-only tightness (4g.20gb over 3g.20gb for a half-GPU
    DNN), with the memory-tight profile as the fallback rung."""
    ladder: list[PartitionProfile] = []
    if est_mem_gb is not None:
        strong = backend.tightest_profile(est_mem_gb, compute_demand)
        if strong is not None:
            ladder.append(strong)
    weak = tight_profile(backend, est_mem_gb)
    if all(p.name != weak.name for p in ladder):
        ladder.append(weak)
    return ladder


def restart_rung(backend: PartitionBackend,
                 current: PartitionProfile) -> PartitionProfile:
    """Next-larger-memory rung after an OOM crash (paper's 10GB -> 20GB
    example); the largest profile has nowhere to grow and stays itself."""
    nxt = backend.next_larger_profile(current)
    return nxt if nxt is not None else backend.profiles[-1]


def predicted_rung(backend: PartitionBackend, predicted_peak_gb: float,
                   headroom: float = 1.0) -> PartitionProfile | None:
    """Tightest rung holding a predicted peak (+ optional headroom) — the
    early-restart target (§2.3); None when nothing on this device fits."""
    return backend.tightest_profile(predicted_peak_gb * headroom)


def grow_ladder(backend: PartitionBackend, current: PartitionProfile,
                predicted_gb: float | None,
                compute_demand: float) -> list[PartitionProfile]:
    """Larger profiles to try, preferred first.  Memory need comes from the
    predictor (early restart) or the next-larger restart rung (OOM restart);
    compute is the paper's soft constraint — prefer slices that also relieve
    decode starvation, but degrade down the compute tiers rather than fail
    (a fragmented FSM often cannot host the compute-maximal placement)."""
    nxt = restart_rung(backend, current)
    need_gb = min(max(predicted_gb or 0.0, nxt.mem_gb),
                  backend.profiles[-1].mem_gb)
    bigger = [p for p in backend.profiles
              if p.mem_gb > current.mem_gb and p.mem_gb >= need_gb]
    def rank(p):
        return (p.mem_gb, -p.compute_fraction)
    strong = sorted((p for p in bigger
                     if p.compute_fraction >= compute_demand), key=rank)
    weak = sorted((p for p in bigger
                   if p.compute_fraction < compute_demand), key=rank)
    return strong + weak or [nxt]


def shrink_ladder(backend: PartitionBackend, current: PartitionProfile,
                  floor_gb: float) -> list[PartitionProfile]:
    """Smaller profiles to try, deepest shrink first: every profile with
    less memory than the current slice that still holds ``floor_gb`` (the
    engine's live bytes plus admission headroom), ordered by ascending
    memory then ascending compute — the rung surrendering the most
    wattage leads, and the cost model's trade tier decides how far down
    the risk actually lets the engine go."""
    return sorted((p for p in backend.profiles
                   if p.mem_gb < current.mem_gb and p.mem_gb >= floor_gb),
                  key=lambda p: (p.mem_gb, p.compute_fraction))


def place_request(backend: PartitionBackend, est_mem_gb: float | None,
                  compute_demand: float,
                  reconfig_cost_s: float) -> PlanRequest:
    """A first-placement request (scheme B / fleet dispatch)."""
    return PlanRequest(
        ladder=placement_ladder(backend, est_mem_gb, compute_demand),
        need_gb=est_mem_gb if est_mem_gb is not None else 0.0,
        compute_demand=compute_demand,
        reconfig_cost_s=reconfig_cost_s)


def grow_request(backend: PartitionBackend, current: Partition,
                 predicted_gb: float | None,
                 compute_demand: float,
                 reconfig_cost_s: float = 0.0,
                 queue_depth: float = 0.0,
                 slo_violation_prob: float = 0.0,
                 slo_relief: float | None = None,
                 needed_compute: float = 0.0,
                 allow_stay: bool = False) -> PlanRequest:
    """A grow/migrate request for a live partition (serving engines).  The
    current slice is released first; idle reuse is off — a migration always
    re-carves so the released space can fuse into the target.

    SLO-pressure growth passes ``slo_violation_prob`` (+ ``allow_stay``)
    so the plan *trades* the predicted p99 miss against ``reconfig_cost_s``
    — see :func:`repro_torch.core.planner.cost.serving_grow_cost`;
    memory-forced growth (OOM, converged predictor) leaves them zero,
    making every rung tie on the trade tier and fall through to the ladder
    order."""
    ladder = grow_ladder(backend, current.profile, predicted_gb,
                         compute_demand)
    return PlanRequest(ladder=ladder,
                       need_gb=predicted_gb if predicted_gb is not None
                       else ladder[0].mem_gb,
                       compute_demand=compute_demand,
                       reuse_idle=False,
                       reconfig_cost_s=reconfig_cost_s,
                       release=current,
                       queue_depth=queue_depth,
                       slo_violation_prob=slo_violation_prob,
                       slo_relief=slo_relief,
                       needed_compute=needed_compute,
                       allow_stay=allow_stay)


def shrink_request(backend: PartitionBackend, current: Partition,
                   floor_gb: float,
                   power_saved_w_by: Mapping[str, float],
                   profile_risk: Mapping[str, float],
                   reconfig_cost_s: float = 0.0) -> PlanRequest:
    """A scale-down request for a live partition (serving engines) — the
    symmetric trade to :func:`grow_request`.  ``floor_gb`` is the memory
    the workload must keep (live KV bytes plus headroom), so every rung
    is feasible by construction; ``power_saved_w_by`` carries the dynamic
    watts each rung surrenders and ``profile_risk`` the probability the
    headroom forecast is wrong at that rung (both per profile name —
    shrink risk *rises* down the ladder where growth risk falls, so the
    grow path's relief scaling cannot express it).  ``allow_stay`` is
    always on: the stay candidate scores zero on the whole trade tier,
    so the engine shrinks exactly when the forecast Joules outweigh the
    risked rebuild — see :func:`repro_torch.core.planner.cost
    .serving_shrink_cost`."""
    return PlanRequest(ladder=shrink_ladder(backend, current.profile,
                                            floor_gb),
                       need_gb=floor_gb,
                       reuse_idle=False,
                       reconfig_cost_s=reconfig_cost_s,
                       release=current,
                       allow_stay=True,
                       shrink=True,
                       power_saved_w_by=power_saved_w_by,
                       profile_risk=profile_risk)
