"""LLM memory prediction (paper §3) — the Qwen2-7B experiment in miniature.

Replays the paper's headline scenario: an LLM with a growing context runs on
a 10GB partition; without prediction it crashes at iteration 94; the
time-series predictor (Algorithm 1) flags the overflow early, and the
scheduler restarts it early on a 20GB slice.  Prints the per-iteration
trace and a comparison of wasted work.

    PYTHONPATH=src python -m repro_torch.launch.llm_memory_prediction

The port's copy of the reference's ``examples/llm_memory_prediction.py``.
Host code: the trajectory is synthetic and the scheduler is the simulator
(:mod:`repro_torch.core.scheduler`) on the A100's MIG geometry, so it
launches nothing on a card and takes no device argument; every makespan
and Joule it prints is the simulator's.
"""

from __future__ import annotations

import argparse

from repro_torch.core.memory.timeseries import PeakMemoryPredictor
from repro_torch.core.mig_a100 import make_backend
from repro_torch.core.scheduler.energy import A100_POWER
from repro_torch.core.scheduler.job import (GB, Job, llm_growth_trajectory,
                                            solve_growth_params)
from repro_torch.core.scheduler.policies import run_scheme_a

PARTITION_GB = 10.0


def run() -> dict:
    """Print the scenario; return the crash and fire iterations and the
    two Scheme A metrics (``oom_at``, ``fired``, ``no_pred``, ``pred``)."""
    k = solve_growth_params(base_gb=6.0, oom_gb=PARTITION_GB, oom_iter=94,
                            req_gb_per_iter=0.5)
    traj = llm_growth_trajectory(n_iters=120, base_gb=6.0,
                                 req_gb_per_iter=0.5, inv_reuse_slope=k,
                                 t_per_iter=1.2, noise_gb=0.03, seed=1)
    oom_at = traj.oom_iteration(PARTITION_GB * GB)
    print(f"trajectory: live memory 6GB -> {traj.peak_phys / GB:.2f}GB, "
          f"crashes on a {PARTITION_GB:.0f}GB slice at iteration {oom_at}")

    predictor = PeakMemoryPredictor(max_iter=traj.n_iters)
    print(f"\n{'iter':>4} {'live GB':>8} {'req GB':>8} {'reuse':>6} "
          f"{'pred peak GB':>12} {'converged':>9}")
    fired = None
    for i, (m, r, live) in enumerate(zip(traj.req_mem, traj.reuse_ratio,
                                         traj.phys_mem)):
        pred = predictor.observe(m, r)
        if i < 10 or i % 20 == 0:
            print(f"{i:4d} {live / GB:8.2f} {m / GB:8.2f} {r:6.3f} "
                  f"{pred.peak_mem_bytes / GB:12.2f} "
                  f"{str(pred.converged):>9}")
        if fired is None and predictor.will_oom(PARTITION_GB * GB, pred):
            fired = i
            print(f"{i:4d} ^^^ PREDICTED OOM — peak "
                  f"{pred.peak_mem_bytes / GB:.2f}GB > {PARTITION_GB:.0f}GB "
                  f"partition; early restart NOW "
                  f"(vs crash at {oom_at}: saves {oom_at - i} iterations)")

    backend = make_backend()

    def qwen_job():
        return Job(name="qwen2", mem_gb=traj.peak_phys / GB, t_kernel=0.0,
                   compute_demand=0.55, trajectory=traj, est_mem_gb=6.5)

    no_pred = run_scheme_a([qwen_job()], backend, A100_POWER,
                           use_prediction=False)
    pred_m = run_scheme_a([qwen_job()], backend, A100_POWER,
                          use_prediction=True)
    print("\nscheduler comparison (scheme A):")
    print(f"  without prediction: makespan {no_pred.makespan:7.1f}s, "
          f"{no_pred.n_oom} OOM crash(es), wasted "
          f"{no_pred.wasted_seconds:.1f}s")
    print(f"  with    prediction: makespan {pred_m.makespan:7.1f}s, "
          f"{pred_m.n_early_restarts} early restart(s), wasted "
          f"{pred_m.wasted_seconds:.1f}s")
    print(f"  => {no_pred.makespan / pred_m.makespan:.2f}x faster, "
          f"{no_pred.energy_j / pred_m.energy_j:.2f}x less energy")
    return {"oom_at": oom_at, "fired": fired, "no_pred": no_pred,
            "pred": pred_m}


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.launch.llm_memory_prediction",
        description=__doc__.splitlines()[0]).parse_args(argv)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
