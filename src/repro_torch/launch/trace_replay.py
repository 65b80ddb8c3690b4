"""Million-event Alibaba-style trace replay with flat memory.

The trace-scale path end to end: a cluster-trace-gpu-v2020-shaped workload
streams through the fleet scheduler without ever existing as a list —

  1. rows come from a lazy generator (:func:`iter_synthetic_alibaba_rows`,
     or ``--csv`` for a real sorted trace via :func:`iter_alibaba_csv`),
  2. :func:`iter_jobs_from_trace` turns each row into a Job as it is
     needed; ``EventKernel.run(..., stream=True)`` keeps exactly one
     future arrival staged in the event queue,
  3. devices run with ``record_runs=False`` (no per-run history list) and
     the flight recorder — when asked for — streams records straight to a
     JSONL sink instead of buffering them,

so peak memory stays flat whether the trace has ten thousand rows or a
million.  The script reports events/sec and (with ``--memstats``) the
tracemalloc peak.

    PYTHONPATH=src python -m repro_torch.launch.trace_replay --events 100000
    PYTHONPATH=src python -m repro_torch.launch.trace_replay --csv trace.csv \\
        --trace replay.jsonl --memstats

The port's copy of the reference's ``examples/trace_replay.py``.  Host
code: every device is the scheduler's device model, so it launches nothing
on a card and takes no device argument; events/s is the host's replay
rate and every other figure the simulator's.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core.scheduler.kernel import EventKernel
from repro_torch.fleet import (FleetPolicy, iter_alibaba_csv,
                               iter_jobs_from_trace,
                               iter_synthetic_alibaba_rows, make_fleet,
                               make_router)
from repro_torch.obs import Tracer


def replay(events: int = 100_000, seed: int = 11, rate: float = 6.5,
           csv: str | None = None, tracer: Tracer | None = None):
    """Stream the trace through a 6xA100 + 6xH100 fleet; returns (kernel,
    metrics, seconds)."""
    if csv:
        rows = iter_alibaba_csv(csv)
    else:
        rows = iter_synthetic_alibaba_rows(events // 2, seed=seed,
                                           rate_per_s=rate)
    jobs = iter_jobs_from_trace(rows)
    fleet = make_fleet(["a100"] * 6 + ["h100"] * 6, record_runs=False)
    policy = FleetPolicy(make_router("energy_aware", seed=seed))
    kernel = EventKernel(fleet, policy, tracer=tracer)
    t0 = time.perf_counter()
    metrics = kernel.run(jobs, stream=True)
    return kernel, metrics, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.trace_replay",
        description="streamed Alibaba-style trace replay")
    ap.add_argument("--events", type=int, default=100_000,
                    help="target event count for the synthetic trace "
                         "(~2 events per job; ignored with --csv)")
    ap.add_argument("--csv", default=None, metavar="TRACE.csv",
                    help="replay a real cluster-trace-gpu-v2020-style CSV "
                         "(must be sorted by submit time) instead of the "
                         "synthetic trace")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--rate", type=float, default=6.5,
                    help="synthetic submissions/sec (default loads the "
                         "12-device fleet to a standing queue)")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="stream the flight-recorder trace to this JSONL "
                         "sink (summarize with python -m "
                         "repro_torch.obs.report)")
    ap.add_argument("--memstats", action="store_true",
                    help="report the tracemalloc peak of the replay")
    args = ap.parse_args(argv)

    tracer = Tracer(sink=args.trace) if args.trace else None
    if args.memstats:
        import tracemalloc
        tracemalloc.start()
    kernel, metrics, elapsed = replay(args.events, args.seed, args.rate,
                                      args.csv, tracer)
    if tracer is not None:
        tracer.close()

    print(f"replayed {kernel.n_jobs_seen} jobs / {kernel.n_events} events "
          f"in {elapsed:.1f}s -> {kernel.n_events / elapsed:.0f} events/s")
    print(metrics.summary())
    for dev in metrics.per_device:
        print("  ", dev.summary())
    if args.memstats:
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        print(f"tracemalloc peak: {peak / 1e6:.1f} MB")
    if tracer is not None:
        print(f"flight-recorder trace streamed to {tracer.sink_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
