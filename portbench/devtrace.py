"""The traced part of a window, reduced to plain records.

``torch.profiler`` runs with CPU and CUDA activity over the traced
batches.  The harness marks each batch with a ``record_function`` span of
its own (``BATCH_SPAN``); the reduction keeps, in nanoseconds of the
profiler's clock:

- ``ops``: every device operation (kernels, copies, fills) as
  (name, start, end);
- ``graph_launches``: the start of every ``cudaGraphLaunch`` call;
- ``batches``: each batch span's (start, end);
- ``host``: the host's operations (name, start, end), for the idle gaps.

Nothing is written to disk.
"""

from __future__ import annotations

import collections
import dataclasses

BATCH_SPAN = "portbench.batch"
#: the characters of a name kept in the breakdown (C++ kernel names carry
#: their whole template argument lists)
NAME_CHARS = 120
GRAPH_LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class Trace:
    ops: list[tuple[str, int, int]]
    graph_launches: list[int]
    batches: list[tuple[int, int]]
    host: list[tuple[str, int, int]]

    @property
    def window(self) -> tuple[int, int]:
        return self.batches[0][0], self.batches[-1][1]


def reduce(prof) -> Trace:
    """The records of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, launches, batches, host = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((name, start, end))
        elif name == BATCH_SPAN:
            batches.append((start, end))
        elif name == GRAPH_LAUNCH:
            launches.append(start)
        else:
            host.append((name, start, end))
    batches.sort()
    ops.sort(key=lambda o: o[1])
    return Trace(ops, sorted(launches), batches, host)


def busy_intervals(ops, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    out: list[list[int]] = []
    for _, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(trace: Trace) -> int:
    lo, hi = trace.window
    return sum(e - s for s, e in busy_intervals(trace.ops, lo, hi))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, summed by name, and
    the longest idle gaps of the device, each named by the innermost host
    operation under way when it began, in seconds."""
    lo, hi = trace.window
    by_name: dict[str, int] = collections.defaultdict(int)
    for name, s, e in trace.ops:
        if s >= lo and e <= hi:
            by_name[name] += e - s
    busy = busy_intervals(trace.ops, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]

    def doing(t: int) -> str:
        under = [(s, name) for name, s, e in trace.host if s <= t < e]
        return max(under)[1] if under else "(no host operation)"

    return {"device_ops": [[name[:NAME_CHARS], ns / 1e9] for name, ns in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[doing(t)[:NAME_CHARS], ns / 1e9] for ns, t in gaps]}
