"""Zero-dependency telemetry: flight recorder, planner decision audit,
streaming counters; the port's copy of ``repro.obs``.

* :mod:`repro_torch.obs.trace` — :class:`Tracer` (typed spans / instants /
  counters / audits), JSONL persistence, Chrome trace_event export for
  chrome://tracing / Perfetto per-device Gantt rendering.
* :mod:`repro_torch.obs.audit` — flattens a planner :class:`Plan` into the
  replayable decision record the regret oracle consumes.
* :mod:`repro_torch.obs.replay` — streams a trace back into reconstructed
  decision points and grades them against the offline oracle
  (:func:`trace_regret`).
* :mod:`repro_torch.obs.counters` — :class:`Counter` / :class:`Gauge` /
  P² streaming quantiles (:class:`P2Quantile`, :class:`TailStats`) and
  a :class:`MetricsRegistry`.
* :mod:`repro_torch.obs.report` —
  ``python -m repro_torch.obs.report trace.jsonl``.

Everything is pay-for-what-you-use: ``tracer=None`` (the default on every
kernel entry point) takes the exact untraced code path.  The trace format
is the reference's, schema name included, so either package's report and
replay read the other's traces.
"""

from repro_torch.obs.audit import (deciding_tier, deciding_tier_from_costs,
                                    decode_handle, decode_state, encode_handle,
                                    encode_state, plan_audit_record,
                                    tier_labels)
from repro_torch.obs.counters import (Counter, Gauge, MetricsRegistry,
                                      P2Quantile, TailStats)
from repro_torch.obs.replay import (DecisionPoint, Replay, TraceRegret,
                                    decision_points, load_replay, trace_regret)
from repro_torch.obs.trace import (SCHEMA, SCHEMA_VERSION, Tracer, read_jsonl,
                                   to_chrome_trace, write_chrome_trace)

__all__ = [
    "Counter", "DecisionPoint", "Gauge", "MetricsRegistry", "P2Quantile",
    "Replay", "TailStats", "SCHEMA", "SCHEMA_VERSION", "TraceRegret",
    "Tracer", "deciding_tier", "deciding_tier_from_costs",
    "decision_points", "decode_handle", "decode_state", "encode_handle",
    "encode_state", "load_replay", "plan_audit_record", "read_jsonl",
    "tier_labels", "to_chrome_trace", "trace_regret", "write_chrome_trace",
]
