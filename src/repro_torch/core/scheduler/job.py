"""Job model for the batch scheduler (paper §2.3, §4.3, §5); the port's
copy of ``repro.core.scheduler.job``.

A job is either *static* (memory known via compiler analysis / DNNMem — the
Rodinia and DNN mixes) or *dynamic* (memory grows per iteration — the LLM
mixes), in which case it carries a per-iteration memory trajectory that the
simulator replays against the partition it runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

GB = 1024 ** 3


@dataclasses.dataclass
class MemoryTrajectory:
    """Per-iteration allocator statistics of a dynamic job."""

    req_mem: list[float]       # cumulative requested bytes per iteration
    reuse_ratio: list[float]   # in_use / requested per iteration
    phys_mem: list[float]      # live bytes per iteration (OOM check)
    t_per_iter: float          # seconds per iteration

    @property
    def n_iters(self) -> int:
        return len(self.phys_mem)

    @property
    def peak_phys(self) -> float:
        return max(self.phys_mem)

    def oom_iteration(self, partition_bytes: float) -> int | None:
        """First iteration whose live memory exceeds the partition."""
        for i, m in enumerate(self.phys_mem):
            if m > partition_bytes:
                return i
        return None


@dataclasses.dataclass
class Job:
    name: str
    mem_gb: float                       # true peak physical memory (GB)
    t_kernel: float                     # device compute seconds at full demand
    compute_demand: float = 1.0         # fraction of device compute usable
    t_fixed: float = 0.5                # setup/teardown seconds
    t_io: float = 0.0                   # host<->device transfer seconds
    io_bw_demand: float = 0.1           # fraction of PCIe/host-link bandwidth
    est_mem_gb: float | None = None     # scheduler's estimate; None = unknown
    trajectory: MemoryTrajectory | None = None
    arrival: float = 0.0
    size_class: str = ""                # small/medium/large/full (paper mixes)
    #: memoized dynamic execution plans per (backend, profile, predict) —
    #: the trajectory replay is O(n_iters), and restart loops re-place the
    #: same job on the same profiles repeatedly
    plan_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    def runtime_on(self, compute_fraction: float, io_stretch: float = 1.0
                   ) -> float:
        """Execution time on a slice with ``compute_fraction`` of the device.

        Compute scales with min(need, slice) — the paper's warp-folding
        argument: a slice smaller than the demand stretches kernel time by
        demand/slice; a larger slice gives no speedup.  IO (PCIe on A100,
        host link on TPU) is a shared resource: ``io_stretch`` is the
        bandwidth-oversubscription factor of the concurrent set (paper §5.1
        and [24] — NW stretches ~2.2x under 7-way sharing, myocyte's
        latency-bound copies do not, Table 3 vs Table 4).
        """
        c = max(min(compute_fraction, 1.0), 1e-6)
        stretch = max(1.0, self.compute_demand / c)
        return self.t_fixed + self.t_kernel * stretch + self.t_io * io_stretch

    def kernel_seconds_on(self, compute_fraction: float) -> float:
        c = max(min(compute_fraction, 1.0), 1e-6)
        return self.t_kernel * max(1.0, self.compute_demand / c)

    @property
    def is_dynamic(self) -> bool:
        return self.trajectory is not None


def llm_growth_trajectory(n_iters: int,
                          base_gb: float,
                          req_gb_per_iter: float,
                          inv_reuse_slope: float,
                          t_per_iter: float,
                          noise_gb: float = 0.02,
                          warmup_iters: int = 0,
                          seed: int = 0) -> MemoryTrajectory:
    """Synthesize a growing-context LLM trajectory (paper §2.3: Qwen2-7B's
    context growth until OOM).

    The paper's empirical model (§3.2.3) is that (a) cumulative requested
    memory is linear in the iteration — ``req(t) = base + r*t`` — and (b) the
    *inverse* reuse ratio is linear — ``inv(t) = 1 + k*t`` (reuse improves as
    the allocator recycles blocks).  Physical (live) memory is their ratio,

        live(t) = req(t) / inv(t)

    which grows toward the asymptote r/k.  We sample from exactly this model
    plus Gaussian noise; the trajectory OOMs when live crosses the partition
    size, and the predictor (which fits the same two linear laws) can fire
    within a handful of iterations — reproducing the paper's
    predict-at-6-vs-crash-at-94 behaviour.

    ``warmup_iters`` models workloads whose memory is flat before the
    context starts growing (FLAN-T5 in the paper converges later — iteration
    31/21 — because its early iterations show no trend to extrapolate).
    """
    rng = np.random.default_rng(seed)
    phys, req, reuse = [], [], []
    for t in range(n_iters):
        g = max(0, t - warmup_iters)
        r_t = (base_gb + req_gb_per_iter * g) * GB
        inv_t = 1.0 + inv_reuse_slope * g
        live = r_t / inv_t + float(rng.normal(0.0, noise_gb)) * GB
        live = max(live, 0.05 * GB)
        phys.append(live)
        req.append(r_t)
        reuse.append(min(live / r_t, 1.0))
    return MemoryTrajectory(req_mem=req, reuse_ratio=reuse, phys_mem=phys,
                            t_per_iter=t_per_iter)


def solve_growth_params(base_gb: float, oom_gb: float, oom_iter: int,
                        req_gb_per_iter: float) -> float:
    """Inverse-reuse slope k such that live(oom_iter) == oom_gb given the
    request rate — used to calibrate mixes to the paper's OOM iterations."""
    # (base + r*T) / (1 + k*T) = oom  =>  k = ((base + r*T)/oom - 1) / T
    return ((base_gb + req_gb_per_iter * oom_iter) / oom_gb - 1.0) / oom_iter


# -- paper workload mixes (§5, Appendix A.1) ----------------------------------
# Size classes map to A100 slices: small<=5GB, medium<=10GB, large<=20GB,
# full<=40GB.  t_kernel/t_io shapes follow the paper's per-benchmark
# observations (e.g. myocyte is IO-heavy: Table 3; NW is transfer-bound:
# Table 4; euler3D occupies the 20GB slice: §5.1).

_RODINIA_POOL: dict[str, dict] = {
    # name: mem_gb, t_kernel, compute_demand, t_io, io_bw_demand, class
    # io_bw_demand: fraction of host-link bandwidth the job's transfers use —
    # myocyte's long copies are latency-bound (Table 3: no stretch at 7-way),
    # NW saturates PCIe (Table 4: ~2.2x runtime at 7-way).
    "particlefilter": dict(mem_gb=4.0, t_kernel=2.0, compute_demand=0.30,
                           t_io=0.8, io_bw_demand=0.15, size_class="small"),
    "gaussian":       dict(mem_gb=3.5, t_kernel=3.0, compute_demand=0.25,
                           t_io=0.3, io_bw_demand=0.05, size_class="small"),
    "myocyte":        dict(mem_gb=1.0, t_kernel=0.4, compute_demand=0.10,
                           t_io=3.4, io_bw_demand=0.05, size_class="small"),
    "nw":             dict(mem_gb=4.5, t_kernel=0.6, compute_demand=0.20,
                           t_io=1.6, io_bw_demand=0.90, size_class="small"),
    "euler3d":        dict(mem_gb=18.0, t_kernel=6.0, compute_demand=0.45,
                           t_io=0.8, io_bw_demand=0.20, size_class="large"),
    "srad":           dict(mem_gb=8.0, t_kernel=2.5, compute_demand=0.35,
                           t_io=0.6, io_bw_demand=0.15, size_class="medium"),
    "lavamd":         dict(mem_gb=9.5, t_kernel=4.0, compute_demand=0.40,
                           t_io=0.5, io_bw_demand=0.10, size_class="medium"),
    "hotspot3d":      dict(mem_gb=16.0, t_kernel=3.5, compute_demand=0.50,
                           t_io=0.7, io_bw_demand=0.20, size_class="large"),
    "cfd_full":       dict(mem_gb=34.0, t_kernel=8.0, compute_demand=0.90,
                           t_io=1.2, io_bw_demand=0.30, size_class="full"),
    "streamcluster":  dict(mem_gb=30.0, t_kernel=7.0, compute_demand=0.85,
                           t_io=1.0, io_bw_demand=0.25, size_class="full"),
}


def rodinia_job(name: str, idx: int = 0) -> Job:
    spec = dict(_RODINIA_POOL[name])
    return Job(name=f"{name}:{idx}", est_mem_gb=spec["mem_gb"], **spec)


def make_mix(spec: Sequence[tuple[str, int]]) -> list[Job]:
    jobs: list[Job] = []
    for name, count in spec:
        jobs.extend(rodinia_job(name, i) for i in range(count))
    return jobs
