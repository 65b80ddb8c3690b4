"""Replay loader: reconstruct every audited decision point from a trace;
the port's copy of ``repro.obs.replay``.

A flight-recorder JSONL written with a kernel-bound :class:`~repro_torch.
obs.trace.Tracer` is a *self-contained replay substrate*: ``{"type": "job"}``
records carry each admitted batch job's relaxed-duration spec, run spans
carry the placed partition handle, and planner audits carry the FSM state
plus each candidate's structured ``(kind, profile, handle)``.  This
module streams those records back and re-derives, for every audited plan
search, the exact decision point the planner faced — which jobs had
arrived, which were done, which slices were running what, and what the
planner chose — without importing any of the live simulation objects.

Records are buffered in *emission* order, which the event kernel makes
causal: a job record precedes any of its runs, a run span is emitted at
its start time, and an audit is emitted at the instant of the plan
search.  So at an audit stamped ``t``, the open runs are exactly the
earlier spans with ``t0 <= t < t1``, the done jobs are those with a
``done`` run closing at or before ``t``, and the pending queue is
arrivals minus done minus running, in admission order.

The reconstruction feeds :func:`repro_torch.core.planner.oracle.
attribute_decisions`.  The backend table maps a recorded backend name to
the port's own MIG modules, so a trace from either package replays here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Hashable

from repro_torch.obs.audit import decode_handle, decode_state
from repro_torch.obs.trace import read_jsonl

#: audit["backend"] type name -> backend factory (lazy, lru-cached inside)
_BACKENDS = {
    "MigA100Backend": "repro_torch.core.mig_a100",
    "MigH100Backend": "repro_torch.core.mig_h100",
}


@dataclasses.dataclass(frozen=True)
class RunSpan:
    """One run span, decoded: which job held which slice over [t0, t1)."""

    job: str
    device: str
    profile: str | None
    handle: Hashable
    t0: float
    t1: float
    outcome: str


@dataclasses.dataclass
class DecisionPoint:
    """One audited plan search plus its re-derived surrounding state."""

    t: float
    device: str
    record: dict[str, Any]          # the raw audit record
    state: Hashable                 # decoded FSM state at the search
    running: list[RunSpan]          # open runs at t (t0 <= t < t1)
    pending: list[str]              # queued job names, admission order
    started_job: str | None         # the job the committed plan launched
    chosen_handle: Hashable | None  # decoded handle of the chosen action


@dataclasses.dataclass
class Replay:
    """A parsed trace, split into the record families replay cares about."""

    header: dict[str, Any]
    records: list[dict[str, Any]]
    jobs: list[dict[str, Any]]          # {"type": "job"} specs
    runs: list[RunSpan]                 # cat="run" spans, decoded
    audits: list[dict[str, Any]]        # {"type": "audit"} records
    path: str

    @property
    def meta(self) -> dict[str, Any]:
        return self.header.get("meta", {})

    @property
    def t_end(self) -> float | None:
        t = self.meta.get("t_end")
        return float(t) if t is not None else None

    @property
    def policy(self) -> str:
        return str(self.meta.get("policy", ""))

    def backend_name(self) -> str | None:
        """The backend type name the audits were recorded against."""
        for a in self.audits:
            name = a.get("backend")
            if name:
                return name
        return None

    def backend(self):
        """Instantiate the recorded backend, or None when the trace holds
        no replayable backend name (e.g. an audit-free baseline run)."""
        name = self.backend_name()
        module = _BACKENDS.get(name or "")
        if module is None:
            return None
        import importlib
        return importlib.import_module(module).make_backend()


def _decode_run(rec: dict[str, Any]) -> RunSpan:
    args = rec.get("args", {})
    return RunSpan(job=str(rec.get("name", "")),
                   device=str(rec.get("device", "")),
                   profile=args.get("profile"),
                   handle=decode_handle(args.get("handle")),
                   t0=float(rec["t0"]), t1=float(rec["t1"]),
                   outcome=str(args.get("outcome", "")))


def load_replay(path: str) -> Replay:
    """Parse a trace file into a :class:`Replay` (raises like
    :func:`repro_torch.obs.trace.read_jsonl` on schema refusal)."""
    header, records = read_jsonl(path)
    jobs: list[dict[str, Any]] = []
    runs: list[RunSpan] = []
    audits: list[dict[str, Any]] = []
    for rec in records:
        kind = rec.get("type")
        if kind == "job":
            jobs.append(rec)
        elif kind == "span" and rec.get("cat") == "run":
            runs.append(_decode_run(rec))
        elif kind == "audit":
            audits.append(rec)
    return Replay(header=header, records=records, jobs=jobs, runs=runs,
                  audits=audits, path=path)


def decision_points(replay: Replay, *, eps: float = 1e-9
                    ) -> list[DecisionPoint]:
    """Re-derive every batch-planner decision point, in emission order.

    Only audits that recorded an FSM ``state`` are decision points (the
    serving grow/wait audits are graded separately, by
    :func:`repro_torch.core.planner.oracle.grow_wait_sequence_bound`).
    """
    points: list[DecisionPoint] = []
    arrived: list[str] = []          # admission order
    runs_before: list[RunSpan] = []  # run spans emitted so far
    run_cursor = 0                   # index into replay.runs (for lookahead)
    runs_by_order = replay.runs

    for rec in replay.records:
        kind = rec.get("type")
        if kind == "job":
            arrived.append(str(rec["name"]))
            continue
        if kind == "span" and rec.get("cat") == "run":
            runs_before.append(runs_by_order[run_cursor])
            run_cursor += 1
            continue
        if kind != "audit" or "state" not in rec:
            continue
        t = float(rec.get("t", 0.0))
        device = str(rec.get("device", ""))
        running = [r for r in runs_before
                   if r.t0 <= t + eps and r.t1 > t + eps]
        done = {r.job for r in runs_before
                if r.outcome == "done" and r.t1 <= t + eps}
        busy = {r.job for r in running}
        pending = [name for name in arrived
                   if name not in done and name not in busy]
        chosen = rec.get("chosen")
        chosen_handle = None
        if chosen is not None:
            cand = rec["candidates"][chosen]
            if cand.get("handle") is not None:
                chosen_handle = decode_handle(cand["handle"])
        started = None
        if chosen_handle is not None:
            # the committed plan's run starts at the same instant, on the
            # same device, holding the chosen handle — the next such span
            for r in runs_by_order[run_cursor:]:
                if r.t0 > t + eps:
                    break
                if (r.device == device and abs(r.t0 - t) <= eps
                        and r.handle == chosen_handle):
                    started = r.job
                    break
        points.append(DecisionPoint(
            t=t, device=device, record=rec,
            state=decode_state(rec["state"]), running=running,
            pending=pending, started_job=started,
            chosen_handle=chosen_handle))
    return points


# ---------------------------------------------------------------------------
# trace-level regret


@dataclasses.dataclass
class TraceRegret:
    """A full trace graded against the oracle."""

    policy: str
    backend_name: str | None
    makespan_s: float | None        # the traced run's t_end
    oracle: Any                     # OracleResult | None (no jobs/backend)
    makespan_regret_s: float | None
    decisions: list[Any]            # list[DecisionRegret]
    serving: Any                    # GrowWaitBound | None


def trace_regret(replay: Replay, *, node_budget: int | None = None,
                 attribution_limit: int | None = None) -> TraceRegret:
    """Grade one replayed trace: policy makespan vs the oracle optimum,
    per-decision regret attribution, and the serving grow/wait bound."""
    from repro_torch.core.planner.oracle import (DEFAULT_NODE_BUDGET,
                                                 BatchOracle,
                                                 attribute_decisions,
                                                 classes_from_specs,
                                                 grow_wait_sequence_bound)
    backend = replay.backend()
    result = None
    decisions: list[Any] = []
    regret = None
    if replay.jobs and backend is not None:
        oracle = BatchOracle(
            backend, classes_from_specs(replay.jobs),
            node_budget=node_budget or DEFAULT_NODE_BUDGET)
        result = oracle.solve()
        if replay.t_end is not None:
            regret = replay.t_end - result.makespan_s
        decisions = attribute_decisions(
            oracle, decision_points(replay), limit=attribution_limit)
    return TraceRegret(policy=replay.policy,
                       backend_name=replay.backend_name(),
                       makespan_s=replay.t_end, oracle=result,
                       makespan_regret_s=regret, decisions=decisions,
                       serving=grow_wait_sequence_bound(replay.audits))
