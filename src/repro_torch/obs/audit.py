"""Planner decision audit: every candidate's cost vector, and why one won;
the port's copy of ``repro.obs.audit``.

The planner already returns an explainable :class:`~repro_torch.core.
planner.planner.Plan` — this module flattens it into the plain-dict record
shape the flight recorder buffers and the regret oracle
(:mod:`repro_torch.core.planner.oracle`, arXiv:2409.06646) replays: for
each considered candidate the full :class:`~repro_torch.core.planner.cost.
CostTerms` feature vector and the evaluated lexicographic cost tuple; for
the chosen one, the *deciding tier* — the first tier of the cost model at which the
winner strictly beat the best runner-up.  That single index answers "why
this action?": a Grow that wins at the ``(slo_violation_prob+reconfig_s)``
tier was bought by SLO pressure; one that only wins at ``ladder_rank``
merely sat higher on the ladder.

Records also carry the planner's FSM state, the backend's type name and
each candidate's structured ``(kind, profile, handle)`` — JSON-encodable
via :func:`encode_state` / :func:`encode_handle` — which is what lets
:mod:`repro_torch.obs.replay` reconstruct every decision point without the
live objects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Sequence

from repro_torch.core.planner.actions import (FreshAllocate, Grow,
                                               ReshapeFuseFission, ReuseIdle,
                                               Shrink, Wait)
from repro_torch.core.planner.cost import CostModel
from repro_torch.core.planner.planner import Plan


def encode_handle(handle: Hashable) -> Any:
    """JSON-encodable form of a partition handle.  MIG handles are
    ``(start_gpc, profile_name)`` tuples and encode as two-element lists;
    anything else (the TPU buddy pod) falls back to ``repr``."""
    if (isinstance(handle, tuple) and len(handle) == 2
            and isinstance(handle[0], int) and isinstance(handle[1], str)):
        return [handle[0], handle[1]]
    return repr(handle)


def decode_handle(obj: Any) -> Hashable:
    """Inverse of :func:`encode_handle` for MIG handles; ``repr`` fallbacks
    come back as the string (opaque but stable for equality)."""
    if (isinstance(obj, (list, tuple)) and len(obj) == 2
            and isinstance(obj[0], int) and isinstance(obj[1], str)):
        return (obj[0], obj[1])
    return obj


def encode_state(state: Hashable) -> Any:
    """JSON-encodable form of an FSM state.  MIG states are frozensets of
    handles and encode as a sorted list of encoded handles; anything else
    falls back to ``repr``."""
    if isinstance(state, (frozenset, set)):
        try:
            return sorted(encode_handle(h) for h in state)
        except TypeError:
            return repr(state)
    return repr(state)


def decode_state(obj: Any) -> Hashable:
    """Inverse of :func:`encode_state` for MIG states."""
    if isinstance(obj, list):
        return frozenset(decode_handle(h) for h in obj)
    return obj


def tier_labels(model: CostModel) -> list[str]:
    """Human label per lexicographic tier (groups join with '+')."""
    labels = []
    for tier in model.weights:
        if isinstance(tier[0], str):
            labels.append(tier[0])
        else:
            labels.append("+".join(f for f, _ in tier))
    return labels


def deciding_tier_from_costs(chosen: Sequence[float],
                             runner_up: Sequence[float]) -> int | None:
    """First tier index where ``chosen`` strictly differs from
    ``runner_up``; ``None`` on an exact tie.  The tuples must be the same
    length — a mismatch means the records were written under a different
    cost-model version, and silently zip-truncating them would attribute
    the decision to a wrong tier (and, downstream, a wrong regret)."""
    if len(chosen) != len(runner_up):
        raise ValueError(
            f"cost-tuple length mismatch: {len(chosen)} vs "
            f"{len(runner_up)} tiers — candidates scored under different "
            f"cost-model versions cannot share one deciding tier")
    for i, (a, b) in enumerate(zip(chosen, runner_up)):
        if a != b:
            return i
    return None


def deciding_tier(plan: Plan) -> int | None:
    """Index of the first cost tier where the chosen candidate strictly
    beats the best runner-up; None when there is no chosen candidate, no
    runner-up, or an exact cost tie (the winner won on stable order)."""
    if plan.chosen is None or len(plan.candidates) < 2:
        return None
    others = [c for c in plan.candidates if c is not plan.chosen]
    runner_up = min(others, key=lambda c: c.cost)
    return deciding_tier_from_costs(plan.chosen.cost, runner_up.cost)


def _candidate_shape(action) -> tuple[str, str | None, Any]:
    """Structured ``(kind, profile_name, encoded_handle)`` of a candidate
    action — the replay-facing identity of what the planner considered."""
    if isinstance(action, ReuseIdle):
        part = action.partition
        return "reuse", part.profile.name, encode_handle(part.handle)
    if isinstance(action, FreshAllocate):
        pl = action.placement
        return "allocate", pl.profile.name, encode_handle(pl.handle)
    if isinstance(action, ReshapeFuseFission):
        pl = action.placement
        return "reshape", pl.profile.name, encode_handle(pl.handle)
    if isinstance(action, (Grow, Shrink)):
        return _candidate_shape(action.inner)
    if isinstance(action, Wait):
        return "wait", None, None
    # Migrate (and any future action type): opaque but stable
    return type(action).__name__.lower(), getattr(
        getattr(action, "profile", None), "name", None), None


def plan_audit_record(plan: Plan, *, t: float, device: str = "",
                      owner: str = "", state: Hashable | None = None,
                      backend: Any = None) -> dict[str, Any]:
    """Flatten one plan search into an ``{"type": "audit", ...}`` record."""
    labels = tier_labels(plan.model)
    tier = deciding_tier(plan)
    candidates = []
    for cand in plan.candidates:
        kind, pname, handle = _candidate_shape(cand.action)
        candidates.append({
            "action": cand.action.describe(),
            "kind": kind,
            "profile": pname,
            "handle": handle,
            "terms": dataclasses.asdict(cand.terms),
            "cost": list(cand.cost),
        })
    chosen_idx = (plan.candidates.index(plan.chosen)
                  if plan.chosen is not None else None)
    record = {
        "type": "audit",
        "t": t,
        "device": device,
        "owner": owner,
        "model": plan.model.name,
        "tiers": labels,
        "ladder": [p.name for p in plan.request.ladder],
        "release": (plan.request.release.profile.name
                    if plan.request.release is not None else None),
        "candidates": candidates,
        "chosen": chosen_idx,
        "action": plan.action.describe(),
        "deciding_tier": tier,
        "deciding_tier_label": labels[tier] if tier is not None else None,
    }
    if state is not None:
        record["state"] = encode_state(state)
    if backend is not None:
        record["backend"] = type(backend).__name__
    if plan.request.release is not None:
        record["release_handle"] = encode_handle(
            plan.request.release.handle)
    return record
