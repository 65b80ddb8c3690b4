"""The serving engine's own spans in a traced run.

While a profiler records, ``ServeEngine.run`` marks its stages with
``record_function`` ranges named ``repro_torch.serve.<stage>``; the
reduced trace keeps them among the host operations (``Trace.host``), on
the device operations' clock.  A program that records no such spans
gives ``None`` here, and the readers built on this leave their metric
out.
"""

from __future__ import annotations

PREFIX = "repro_torch.serve."


def in_batches(rec, stage: str) -> list[list[tuple[int, int]]] | None:
    """For each traced batch, the (start, end) of the engine's ``stage``
    spans that lie inside it, by start; ``None`` where a batch has
    none."""
    name = PREFIX + stage
    mine = sorted((s, e) for n, s, e in rec.trace.host if n == name)
    out = [[(s, e) for s, e in mine if lo <= s and e <= hi]
           for lo, hi in rec.trace.batches]
    return out if out and all(out) else None
