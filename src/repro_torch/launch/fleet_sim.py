"""Fleet routing-policy comparison: throughput, makespan and Joules across
fleet shapes (1xA100, 4xA100, 2xA100+2xH100) under open-loop Poisson
arrivals of the paper's Rodinia-style mix.

    PYTHONPATH=src python -m repro_torch.launch.fleet_sim

The port's copy of the reference's ``benchmarks/bench_fleet.py``, with its
checks.  Host code: each device is the scheduler's device model
(:class:`repro_torch.core.scheduler.events.DeviceSim`), so this launches
nothing on a card and takes no device argument; every throughput, makespan
and Joule it prints is the simulator's output, not a measurement of a
card.  Everything is seeded, so the table is bit-reproducible.  The
headline property (checked at the bottom, raising ``AssertionError``): on
the 4xA100 Poisson mix, energy-aware consolidation routing beats
round-robin on Joules while giving up no more than 5% throughput — the
makespan is arrival-dominated either way, but round-robin keeps all four
idle floors burning while consolidation power-gates the devices it
empties.
"""

from __future__ import annotations

from repro_torch.core.scheduler.job import rodinia_job
from repro_torch.fleet import (make_fleet, make_router, poisson_arrivals,
                               run_fleet)

FLEET_SHAPES = {
    "1xA100": ["a100"],
    "4xA100": ["a100"] * 4,
    "2xA100+2xH100": ["a100", "a100", "h100", "h100"],
}

POLICIES = ["round_robin", "random", "best_fit", "energy_aware"]

N_JOBS = 60
ARRIVAL_RATE = 0.4    # jobs/s — moderate load: ~1 device's worth of work
SEED = 7

_POOL = ["myocyte", "gaussian", "srad", "euler3d", "particlefilter",
         "nw", "lavamd", "hotspot3d", "cfd_full"]


def _jobs():
    """Fresh job objects per run — the sim mutates estimates in place."""
    jobs = [rodinia_job(_POOL[i % len(_POOL)], i) for i in range(N_JOBS)]
    return poisson_arrivals(jobs, rate_per_s=ARRIVAL_RATE, seed=SEED)


def run(csv_rows: list) -> dict:
    """Every fleet shape under every policy; returns the FleetMetrics by
    (shape, policy)."""
    print("\n=== Fleet routing policies: Poisson arrivals, "
          f"{N_JOBS} jobs @ {ARRIVAL_RATE}/s (seed {SEED}) ===")
    header = (f"{'fleet':<14} {'policy':<13} {'thpt/s':>7} {'makespan':>9} "
              f"{'energy_kJ':>10} {'J/job':>7} {'gated_s':>8} {'reconf':>7}")
    results: dict[tuple[str, str], object] = {}
    for shape_name, shape in FLEET_SHAPES.items():
        print("\n" + header)
        for policy in POLICIES:
            m = run_fleet(make_fleet(shape), make_router(policy, seed=SEED),
                          _jobs())
            results[(shape_name, policy)] = m
            print(f"{shape_name:<14} {policy:<13} {m.throughput:7.4f} "
                  f"{m.makespan:9.1f} {m.energy_j / 1e3:10.2f} "
                  f"{m.energy_per_job:7.0f} {m.gated_seconds:8.0f} "
                  f"{m.n_reconfigs:7d}")
            csv_rows.append((f"fleet.{shape_name}.{policy}.energy_kj", 0.0,
                             f"{m.energy_j / 1e3:.2f}"))
            csv_rows.append((f"fleet.{shape_name}.{policy}.thpt", 0.0,
                             f"{m.throughput:.4f}"))

    rr = results[("4xA100", "round_robin")]
    ea = results[("4xA100", "energy_aware")]
    saving = 1.0 - ea.energy_j / rr.energy_j
    thpt_ratio = ea.throughput / rr.throughput
    print(f"\n4xA100: energy_aware vs round_robin -> "
          f"{saving:.1%} Joules saved at {thpt_ratio:.1%} throughput "
          f"({ea.idle_joules_avoided / 1e3:.1f}kJ of idle floor gated away)")
    if not ea.energy_j < rr.energy_j:
        raise AssertionError("consolidation must save energy")
    if not thpt_ratio >= 0.95:
        raise AssertionError("consolidation must hold 95% throughput")
    csv_rows.append(("fleet.4xA100.energy_saving", 0.0, f"{saving:.3f}"))
    csv_rows.append(("fleet.4xA100.thpt_ratio", 0.0, f"{thpt_ratio:.3f}"))
    return results


def main() -> int:
    rows: list = []
    run(rows)
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
