"""Cluster-of-fleets routing: dollars, Joules and throughput across three
energy zones (A100/H100 mixes) whose tariffs and diurnal arrival clocks
are staggered around the globe.

    PYTHONPATH=src python -m repro_torch.launch.cluster_sim [--trace OUT.jsonl]

Two parts, both on the reference's seeds:

1. the port's copy of the reference's ``benchmarks/bench_cluster.py``
   (:func:`run`): 40 jobs a zone under each zone router, with its check,
   which raises ``AssertionError``: follow-the-sun beats the single-zone
   baseline on dollars while keeping 99% of its throughput;
2. the three arms of the reference's ``examples/cluster_sim.py``
   (:func:`run_whale`): 30 jobs a zone plus one under-estimated "whale"
   submitted in us-east, which OOMs on an A100 and restarts on an H100 —
   in another zone under the cost routers, the one scenario that makes a
   cross-zone ``Migrate``.  ``--trace`` records the follow-the-sun arm's
   flight-recorder trace, as the example's flag does (summarize it with
   ``python -m repro_torch.obs.report``).

Host code: each device is the scheduler's device model
(:class:`repro_torch.core.scheduler.events.DeviceSim`), so this launches
nothing on a card and takes no device argument; every dollar, Joule and
throughput it prints is the simulator's output, not a measurement of a
card.  Everything is seeded, so the output is bit-reproducible.
"""

from __future__ import annotations

import argparse

from repro_torch.cluster import (ZoneTariff, cluster_workload, make_zone,
                                 make_zone_router, run_cluster)
from repro_torch.core.scheduler.job import Job
from repro_torch.obs import Tracer

PERIOD_S = 600.0  # one compressed "day" of tariff + arrival phase
JOBS_PER_ZONE = 40
PEAK_RATE = 0.12  # jobs/s at local noon
TROUGH_RATE = 0.02  # jobs/s at local midnight
SEED = 7

#: the example's workload: fewer jobs a zone, another seed, plus the whale
WHALE_JOBS_PER_ZONE = 30
WHALE_SEED = 42

TARIFF = ZoneTariff("tou", trough_usd_per_kwh=0.05, peak_usd_per_kwh=0.25,
                    period_s=PERIOD_S)

ZONE_SHAPES = [
    ("us-east", ["a100", "a100", "h100"], 0.0),
    ("eu-west", ["a100", "a100", "h100"], PERIOD_S / 3),
    ("ap-south", ["a100", "a100", "h100"], 2 * PERIOD_S / 3),
]

POLICIES = ["single_zone", "price_greedy", "follow_the_sun"]


def _zones():
    """Fresh zones per run — device FSMs and energy integrals are stateful."""
    return [make_zone(name, shape, TARIFF, phase_s=phase)
            for name, shape, phase in ZONE_SHAPES]


def _workload(zones):
    """Fresh job objects per run — the sim mutates estimates in place."""
    return cluster_workload(zones, JOBS_PER_ZONE, period_s=PERIOD_S,
                            peak_rate=PEAK_RATE, trough_rate=TROUGH_RATE,
                            seed=SEED)


def whale_workload(zones):
    """The example's workload: each zone's diurnal mix plus one
    under-estimated whale submitted in us-east, which OOMs on an A100 and
    restarts on an H100 — possibly in another zone, which the planner
    types as a cluster-level Migrate with checkpoint movement."""
    jobs, origin = cluster_workload(zones, WHALE_JOBS_PER_ZONE,
                                    period_s=PERIOD_S, peak_rate=PEAK_RATE,
                                    trough_rate=TROUGH_RATE, seed=WHALE_SEED)
    whale = Job(name="us-east/whale", mem_gb=60.0, t_kernel=10.0,
                compute_demand=0.9, est_mem_gb=30.0, arrival=120.0)
    origin[whale.name] = "us-east"
    return jobs + [whale], origin


def run(csv_rows: list) -> dict:
    """The bench's table under every zone router, with its check; returns
    the ClusterMetrics by policy."""
    n_jobs = JOBS_PER_ZONE * len(ZONE_SHAPES)
    print(f"\n=== Cluster routing: 3 zones x [2xA100+1xH100], {n_jobs} jobs "
          f"under staggered diurnal arrivals (seed {SEED}) ===")
    header = (f"{'policy':<15} {'thpt/s':>7} {'makespan':>9} {'energy_kJ':>10} "
              f"{'dollars':>8} {'$/MJ':>6} {'moved_s':>8} {'xzone':>6}")
    print("\n" + header)
    results = {}
    for policy in POLICIES:
        zones = _zones()
        jobs, origin = _workload(zones)
        m = run_cluster(zones, make_zone_router(policy), jobs, origin=origin)
        results[policy] = m
        print(f"{policy:<15} {m.throughput:7.4f} {m.makespan:9.1f} "
              f"{m.energy_j / 1e3:10.2f} {m.dollars:8.5f} "
              f"{1e6 * m.dollars / m.energy_j:6.2f} "
              f"{m.data_movement_s:8.1f} {m.n_cross_zone_migrations:6d}")
        tag = f"cluster.{policy}"
        csv_rows.append((f"{tag}.dollars", 0.0, f"{m.dollars:.6f}"))
        csv_rows.append((f"{tag}.energy_kj", 0.0, f"{m.energy_j / 1e3:.2f}"))
        csv_rows.append((f"{tag}.thpt", 0.0, f"{m.throughput:.4f}"))

    base = results["single_zone"]
    fts = results["follow_the_sun"]
    saving = 1.0 - fts.dollars / base.dollars
    thpt_ratio = fts.throughput / base.throughput
    print(f"\nfollow_the_sun vs single_zone -> {saving:.1%} dollars saved "
          f"at {thpt_ratio:.1%} throughput "
          f"(${base.dollars:.5f} -> ${fts.dollars:.5f})")
    if not fts.dollars < base.dollars:
        raise AssertionError(
            "follow-the-sun routing must save dollars vs the single-zone "
            f"baseline (${fts.dollars:.6f} vs ${base.dollars:.6f})")
    if not thpt_ratio >= 0.99:
        raise AssertionError(
            f"follow-the-sun must hold 99% of single-zone throughput "
            f"(got {thpt_ratio:.3f})")
    csv_rows.append(("cluster.follow_the_sun.dollar_saving", 0.0,
                     f"{saving:.3f}"))
    csv_rows.append(("cluster.follow_the_sun.thpt_ratio", 0.0,
                     f"{thpt_ratio:.3f}"))
    return results


def run_whale(trace: str | None = None) -> dict:
    """The example's three arms on the whale workload, each zone's summary
    and cross-zone moves printed; ``trace`` records the follow_the_sun
    arm's flight-recorder trace there.  Returns the ClusterMetrics by
    policy."""
    results = {}
    for policy in POLICIES:
        zones = _zones()
        jobs, origin = whale_workload(zones)
        tracer = (Tracer() if trace and policy == "follow_the_sun"
                  else None)
        metrics = run_cluster(zones, make_zone_router(policy), jobs,
                              origin=origin, tracer=tracer)
        results[policy] = metrics
        if tracer is not None:
            n = tracer.write_jsonl(trace)
            print(f"wrote {n} trace records to {trace}")
        print(f"\n== {policy} (whale) ==")
        print(metrics.summary())
        for zone in metrics.per_zone:
            print("  ", zone.summary())
        for move in metrics.migrations:
            print("   cross-zone:", move)
    print("\nfollow-the-sun runs each job where the sun is down and the "
          "tariff is at its trough — same joules, fewer dollars.")
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.cluster_sim")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="record the whale workload's follow_the_sun arm's "
                         "flight-recorder trace (summarize with python -m "
                         "repro_torch.obs.report)")
    args = ap.parse_args(argv)
    rows: list = []
    run(rows)
    run_whale(args.trace)
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
