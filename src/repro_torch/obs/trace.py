"""The flight recorder: typed trace records, JSONL, Chrome trace_event;
the port's copy of ``repro.obs.trace``.

A :class:`Tracer` is an append-only buffer of plain-dict records the
simulation layers emit as they run — spans (a job occupying a slice, a
reconfiguration window, a request's residency in an engine), instants
(queued/placed/OOM/deferred/migrated markers), counters (queue depth,
violation probability over time) and planner audits (see
:mod:`repro_torch.obs.audit`).  The simulators' records carry *simulated*
seconds.  A tracer made by :meth:`Tracer.wall` instead carries seconds of
the wall clock that ``torch.profiler`` stamps its host events with
(``time.time_ns()``), counted from the ``origin_ns`` in its meta, and
:func:`wall_span` records a span there and, while a profiler records, a
``record_function`` range of the same name, so the two traces overlay.

The on-disk format is the reference's: JSONL with a header line (the
schema name is the reference's too, so each package reads the other's
traces)::

    {"schema": "repro.obs.trace", "schema_version": 1, "meta": {...}}
    {"type": "span", "t0": ..., "t1": ..., "name": ..., "device": ...}
    ...

``to_chrome_trace`` converts a record list to the Chrome ``trace_event``
JSON object (``{"traceEvents": [...]}``) that chrome://tracing and
Perfetto load directly: each device becomes a process, each lane (a
partition slot, an engine, a planner) a thread, so the rendered view is a
per-device Gantt of slice occupancy.  Times are exported in microseconds
(the format's unit), i.e. one simulated second = 1e6 trace ticks.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Callable, Iterable

SCHEMA = "repro.obs.trace"
SCHEMA_VERSION = 1


class Tracer:
    """Append-only flight recorder for one simulation run.

    All emit methods are cheap plain-dict appends; the intended zero-cost
    path is the *caller* holding ``tracer=None`` and skipping the call
    entirely, so a tracer never needs an "enabled" flag.

    With ``sink=<path>`` the tracer streams each record to that JSONL file
    the moment it is emitted instead of buffering it — ``records`` stays
    empty, so a million-event replay holds O(1) trace memory.  The header
    goes out first with the construction-time meta; :meth:`finish` appends
    a trailing ``{"type": "meta", ...}`` record carrying the final meta
    (``t_end`` is only known at the end, and line one of a written stream
    cannot be rewritten), which :func:`read_jsonl` folds back into the
    header.  Call :meth:`close` (or use the tracer as a context manager)
    to flush the file.
    """

    def __init__(self, meta: dict[str, Any] | None = None,
                 sink: str | None = None) -> None:
        self.records: list[dict[str, Any]] = []
        self.meta: dict[str, Any] = dict(meta or {})
        self._clock: Callable[[], float] | None = None
        self.sink_path = sink
        self._sink = None
        if sink is not None:
            self._sink = open(sink, "w")
            self._sink.write(json.dumps(self.header()) + "\n")

    @classmethod
    def wall(cls, meta: dict[str, Any] | None = None,
             sink: str | None = None) -> "Tracer":
        """A tracer on the wall clock: its times are seconds since
        ``meta["origin_ns"]``, the ``time.time_ns()`` reading at its
        creation (``meta["clock"] == "time_ns"``)."""
        return cls({**(meta or {}), "clock": "time_ns",
                    "origin_ns": time.time_ns()}, sink)

    def wall_seconds(self, ns: int) -> float:
        """A ``time.time_ns()`` reading in this wall tracer's seconds."""
        return (ns - self.meta["origin_ns"]) / 1e9

    def _emit(self, rec: dict[str, Any]) -> None:
        if self._sink is not None:
            self._sink.write(json.dumps(rec) + "\n")
        else:
            self.records.append(rec)

    def close(self) -> None:
        """Flush and close the streaming sink (no-op when buffering)."""
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- clock -------------------------------------------------------------

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Attach the simulation clock so emitters may omit timestamps."""
        self._clock = clock

    def now(self) -> float:
        return self._clock() if self._clock is not None else 0.0

    # -- emitters ----------------------------------------------------------

    def span(self, t0: float, t1: float, name: str, *, device: str = "",
             lane: str = "", cat: str = "span", **args: Any) -> None:
        """A closed interval [t0, t1] on a device lane (Gantt bar)."""
        rec = {"type": "span", "t0": t0, "t1": t1, "name": name,
               "device": device, "lane": lane, "cat": cat}
        if args:
            rec["args"] = args
        self._emit(rec)

    def instant(self, name: str, *, t: float | None = None,
                device: str = "", lane: str = "", cat: str = "instant",
                **args: Any) -> None:
        """A point event (queued / OOM / deferred / migrated marker)."""
        rec = {"type": "instant", "t": self.now() if t is None else t,
               "name": name, "device": device, "lane": lane, "cat": cat}
        if args:
            rec["args"] = args
        self._emit(rec)

    def counter(self, name: str, value: float, *, t: float | None = None,
                device: str = "") -> None:
        """A time-series sample (rendered as a counter track)."""
        self._emit(
            {"type": "counter", "t": self.now() if t is None else t,
             "name": name, "device": device, "value": value})

    def audit(self, record: dict[str, Any]) -> None:
        """A planner decision audit (shape: audit.plan_audit_record)."""
        self._emit(record)

    def emit(self, record: dict[str, Any]) -> None:
        """An arbitrary pre-shaped record (must carry a ``"type"`` key) —
        the hook for typed records beyond the four built-ins, e.g. the
        event kernel's per-job workload specs that make a trace a
        self-contained replay substrate for the regret oracle."""
        self._emit(record)

    def finish(self, t_end: float) -> None:
        """Stamp the run's end time into the trace metadata."""
        self.meta["t_end"] = t_end
        if self._sink is not None:
            # the header line is already on disk; carry the final meta in a
            # trailing record that read_jsonl folds back into the header
            self._sink.write(json.dumps(
                {"type": "meta", "meta": self.meta}) + "\n")

    # -- serialization -----------------------------------------------------

    def header(self) -> dict[str, Any]:
        return {"schema": SCHEMA, "schema_version": SCHEMA_VERSION,
                "meta": self.meta}

    def write_jsonl(self, path: str) -> int:
        """Write header + records, one JSON object per line; returns the
        number of records written (excluding the header)."""
        if self.sink_path is not None:
            raise RuntimeError(
                f"streaming tracer does not retain records; the trace is "
                f"already at {self.sink_path}")
        with open(path, "w") as f:
            f.write(json.dumps(self.header()) + "\n")
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")
        return len(self.records)


# -- wall-clock spans ---------------------------------------------------------

#: what :func:`wall_span` returns when neither a tracer nor a profiler records
_UNTRACED = contextlib.nullcontext()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process (never before
    torch is imported, so the host layers need not import it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class _WallSpan:
    __slots__ = ("tracer", "name", "args", "range", "t0")

    def __init__(self, tracer: Tracer | None, name: str,
                 args: dict[str, Any], on_profiler: bool) -> None:
        self.tracer, self.name, self.args = tracer, name, args
        self.range = None
        if on_profiler:
            import torch
            self.range = torch.profiler.record_function(name)

    def __enter__(self) -> None:
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.time_ns()

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.tracer is not None:
            self.tracer.span(self.tracer.wall_seconds(self.t0),
                             self.tracer.wall_seconds(t1), self.name,
                             cat="wall", **self.args)


def wall_span(tracer: Tracer | None, name: str, **args: Any):
    """A context manager around one stage of a program on the wall clock:
    a ``record_function(name)`` range while a ``torch.profiler`` records,
    and a ``span`` record in ``tracer`` (made by :meth:`Tracer.wall`) when
    one is given.  With neither it costs one check of whether a profiler
    records."""
    on_profiler = _profiling()
    if tracer is None and not on_profiler:
        return _UNTRACED
    return _WallSpan(tracer, name, args, on_profiler)


def wall_instant(tracer: Tracer | None, name: str, **args: Any) -> None:
    """A point event: an ``instant`` record in ``tracer`` and, while a
    profiler records, a ``record_function`` range of no length."""
    if _profiling():
        import torch
        with torch.profiler.record_function(name):
            pass
    if tracer is not None:
        tracer.instant(name, t=tracer.wall_seconds(time.time_ns()),
                       cat="wall", **args)


def read_jsonl(path: str) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Parse a trace file back into (header, records).

    Raises ``ValueError`` on a missing/foreign header or a schema-version
    mismatch — the same refusal contract as ``benchmarks/compare.py``:
    a stale trace must never render a silently-wrong summary.
    """
    with open(path) as f:
        first = f.readline()
        if not first.strip():
            raise ValueError(f"{path}: empty file, not a trace")
        header = json.loads(first)
        if not isinstance(header, dict) or header.get("schema") != SCHEMA:
            raise ValueError(
                f"{path}: missing trace header (expected schema={SCHEMA!r})")
        got = header.get("schema_version")
        if got != SCHEMA_VERSION:
            raise ValueError(
                f"{path}: schema_version {got} != supported "
                f"{SCHEMA_VERSION}; re-record the trace with this tree")
        records = []
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if rec.get("type") == "meta":
                # trailing meta from a streaming tracer (see Tracer.finish)
                header["meta"] = rec.get("meta", {})
            else:
                records.append(rec)
    return header, records


# -- Chrome trace_event export ---------------------------------------------

_US = 1e6   # simulated seconds -> trace microseconds


def to_chrome_trace(records: Iterable[dict[str, Any]],
                    meta: dict[str, Any] | None = None) -> dict[str, Any]:
    """Convert trace records to a Chrome trace_event JSON object.

    Devices map to processes and lanes to threads (both need integer ids
    in the format, so names are interned in first-appearance order and
    announced via ``M`` metadata events).  Spans become ``X`` complete
    events, instants ``i``, counters ``C``.  Audit records are skipped —
    they are planner-facing, not timeline-facing.
    """
    pids: dict[str, int] = {}
    tids: dict[tuple[str, str], int] = {}
    events: list[dict[str, Any]] = []

    def pid_of(device: str) -> int:
        key = device or "(global)"
        if key not in pids:
            pids[key] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[key], "tid": 0,
                           "args": {"name": key}})
        return pids[key]

    def tid_of(device: str, lane: str) -> int:
        pid = pid_of(device)
        key = (device or "(global)", lane or "(main)")
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tids[key],
                           "args": {"name": key[1]}})
        return tids[key]

    for rec in records:
        kind = rec.get("type")
        if kind == "span":
            events.append({
                "ph": "X", "name": rec["name"], "cat": rec.get("cat", "span"),
                "ts": rec["t0"] * _US,
                "dur": max(0.0, (rec["t1"] - rec["t0"]) * _US),
                "pid": pid_of(rec.get("device", "")),
                "tid": tid_of(rec.get("device", ""), rec.get("lane", "")),
                "args": rec.get("args", {})})
        elif kind == "instant":
            events.append({
                "ph": "i", "s": "t", "name": rec["name"],
                "cat": rec.get("cat", "instant"), "ts": rec["t"] * _US,
                "pid": pid_of(rec.get("device", "")),
                "tid": tid_of(rec.get("device", ""), rec.get("lane", "")),
                "args": rec.get("args", {})})
        elif kind == "counter":
            events.append({
                "ph": "C", "name": rec["name"], "ts": rec["t"] * _US,
                "pid": pid_of(rec.get("device", "")), "tid": 0,
                "args": {rec["name"]: rec["value"]}})
        # audits and unknown types: timeline-irrelevant, skip
    out: dict[str, Any] = {"traceEvents": events,
                           "displayTimeUnit": "ms"}
    if meta:
        out["metadata"] = meta
    return out


def write_chrome_trace(path: str, records: Iterable[dict[str, Any]],
                       meta: dict[str, Any] | None = None) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records, meta), f)
