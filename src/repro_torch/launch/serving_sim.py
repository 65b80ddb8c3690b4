"""Request-level LLM serving: SLO metrics per policy on A100 and H100 MIG.

    PYTHONPATH=src python -m repro_torch.launch.serving_sim

The port's copy of the reference's ``benchmarks/bench_serving.py``: its
arms, its table and its checks.  The paper's LLM serving result (1.43x
throughput, 1.11x energy) evaluated against serving SLOs instead of
makespan: open-loop Poisson request arrivals (heavy-tailed prompt/decode
lengths) into continuous-batching engines on MIG slices.  Policies:

* ``full``         — one engine on the whole device (no MIG),
* ``static``       — two fixed half-memory slices (preempt on pressure),
* ``dynamic``      — slices start small and grow by fission/fusion on OOM
                     crashes and queue pressure,
* ``dynamic+pred`` — same, but the peak predictor early-restarts engines
                     *before* the crash (paper §2.3/§5.2.2).

Host code: the engines are :class:`repro_torch.serving.sim.EngineSim`'s
analytic model (the ``LLMServingModel`` coefficients), so this launches
nothing on a card and takes no device argument.  Every goodput, latency
and Joule it prints is the simulator's output, not a measurement of a
card.  Deterministic (seeded).  Checked at the bottom (raising
``AssertionError``): every request completes, prediction does not lose
goodput vs crash-driven growth, and dynamic MIG serving beats the
monolithic engine on Joules on both generations.
"""

from __future__ import annotations

from repro_torch.serving.sim import (ServingConfig, ServingMetrics,
                                     poisson_requests, run_serving)

N_REQUESTS = 300
ARRIVAL_RATE = 2.0      # req/s — ~80% of the full-device token capacity
SEED = 11

DEVICES = ["a100", "h100"]
#: the dynamic arms pin the queue-tick growth gauge: this compares
#: *mechanisms* (monolith / static / fission-fusion / + prediction) under
#: the original reactive trigger, as the reference's bench does.
CONFIGS = [
    ServingConfig(policy="full"),
    ServingConfig(policy="static", n_engines=2),
    ServingConfig(policy="dynamic", n_engines=2, use_prediction=False,
                  gauge="queue_ticks"),
    ServingConfig(policy="dynamic", n_engines=2, use_prediction=True,
                  gauge="queue_ticks"),
]


def _requests():
    """Fresh request objects per run — the sim mutates them in place."""
    return poisson_requests(N_REQUESTS, rate_per_s=ARRIVAL_RATE, seed=SEED)


def _check(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def run(csv_rows: list) -> dict:
    print(f"\n=== LLM serving: {N_REQUESTS} Poisson requests @ "
          f"{ARRIVAL_RATE}/s (seed {SEED}) ===")
    header = (f"{'device':<7} {'policy':<13} {'goodput':>8} {'ttft':>7} "
              f"{'p99ttft':>8} {'tpot_ms':>8} {'p99lat':>7} {'tok/s':>6} "
              f"{'kJ':>7} {'oom':>4} {'early':>6} {'scaleup':>8}")
    results: dict[tuple[str, str], ServingMetrics] = {}
    payload: dict = {"n_requests": N_REQUESTS, "rate_per_s": ARRIVAL_RATE,
                     "seed": SEED, "configs": {}}
    for device in DEVICES:
        print("\n" + header)
        for cfg in CONFIGS:
            m = run_serving([device], cfg, _requests())
            results[(device, cfg.name)] = m
            print(f"{device:<7} {cfg.name:<13} {m.goodput_rps:8.3f} "
                  f"{m.mean_ttft:7.2f} {m.p99_ttft:8.2f} "
                  f"{m.mean_tpot * 1e3:8.0f} {m.p99_latency:7.1f} "
                  f"{m.tokens_per_s:6.0f} {m.energy_j / 1e3:7.1f} "
                  f"{m.n_oom:4d} {m.n_early_restarts:6d} "
                  f"{m.n_scaleups:8d}")
            tag = f"serving.{device}.{cfg.name}"
            csv_rows.append((f"{tag}.goodput_rps", 0.0,
                             f"{m.goodput_rps:.4f}"))
            csv_rows.append((f"{tag}.p99_ttft_s", 0.0, f"{m.p99_ttft:.3f}"))
            csv_rows.append((f"{tag}.energy_kj", 0.0,
                             f"{m.energy_j / 1e3:.2f}"))
            payload["configs"][f"{device}.{cfg.name}"] = {
                "throughput_rps": m.throughput_rps,
                "goodput_rps": m.goodput_rps,
                "tokens_per_s": m.tokens_per_s,
                "energy_j": m.energy_j,
                "mean_ttft_s": m.mean_ttft,
                "p99_ttft_s": m.p99_ttft,
                "mean_tpot_s": m.mean_tpot,
                "p99_tpot_s": m.p99_tpot,
                "p99_latency_s": m.p99_latency,
                "n_completed": m.n_completed,
                "n_dropped": m.n_dropped,
                "n_oom": m.n_oom,
                "n_early_restarts": m.n_early_restarts,
                "n_scaleups": m.n_scaleups,
                "n_reconfigs": m.n_reconfigs,
            }

    for (device, policy), m in results.items():
        _check(m.n_completed == N_REQUESTS, (device, policy, m.n_completed))
        _check(m.n_dropped == 0, (device, policy))
    for device in DEVICES:
        pred = results[(device, "dynamic+pred")]
        nopred = results[(device, "dynamic")]
        full = results[(device, "full")]
        # early restart's structural win is the tail: growth happens before
        # the crash, so no request sits behind a crashed+rebuilding engine
        _check(pred.p99_ttft <= nopred.p99_ttft + 1e-9,
               f"{device}: prediction must not worsen the TTFT tail")
        _check(pred.n_oom <= nopred.n_oom,
               f"{device}: prediction must not add OOM crashes")
        # goodput is a thresholded tail metric; hold it within 5%
        _check(pred.goodput_rps >= 0.95 * nopred.goodput_rps,
               f"{device}: prediction must not lose goodput")
        best = min(pred, nopred, key=lambda m: m.energy_j)
        _check(best.energy_j < full.energy_j,
               f"{device}: MIG serving must save energy vs the monolith")
        saving = 1.0 - best.energy_j / full.energy_j
        print(f"\n{device}: {best.policy} vs full -> {saving:.1%} Joules "
              f"saved at {best.goodput_rps / full.goodput_rps:.1%} goodput; "
              f"prediction cuts p99 TTFT {nopred.p99_ttft:.2f}s -> "
              f"{pred.p99_ttft:.2f}s")
    return payload


def main() -> int:
    rows: list = []
    run(rows)
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
