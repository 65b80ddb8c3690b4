"""Open-loop arrival generators for the fleet admission queue; the port's
copy of ``repro.fleet.arrivals``.

Three shapes cover the evaluation space of the multi-tenant schedulers the
fleet work builds on (MISO; the Alibaba cluster-trace simulators):

* :func:`poisson_arrivals` — memoryless constant-rate arrivals,
* :func:`diurnal_arrivals` — a day/night sinusoidal rate (thinning method),
* :func:`jobs_from_trace` — replay of Alibaba ``cluster-trace-gpu-v2020``
  style rows (submit time, duration, fractional/multi-GPU request), either
  loaded from a CSV or synthesized with the trace's heavy-tailed shape.

The first two stamp ``arrival`` onto an existing job list in place (the job
mix and the arrival process are independent axes); the trace path builds
the jobs too, since the trace prescribes both.

Everything is numpy-vectorized for million-row traces.  Two equality
regimes apply (pinned by the reference's tests/test_arrivals.py):

* ``poisson_arrivals`` is **bit-for-bit identical** to the original scalar
  loop: ``Generator.exponential(size=n)`` consumes the bit stream exactly
  as n sequential draws, and ``np.cumsum`` adds left-to-right in the same
  float order as ``t += gap`` — so every golden seeded on Poisson arrivals
  is untouched.
* ``diurnal_arrivals`` thinning interleaves a variable number of
  exponential and uniform draws per accepted arrival; no batched call
  sequence can reproduce that interleaved stream.  The vectorized path is
  the default (same process, different sample); ``exact=True`` keeps the
  seed scalar loop for stream-compatible replays.

The streaming trio (:func:`iter_synthetic_alibaba_rows`,
:func:`iter_alibaba_csv`, :func:`iter_jobs_from_trace`) yields
rows/jobs lazily so ``EventKernel.run(..., stream=True)`` replays a
million-row trace without ever materializing it twice.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from collections import Counter
from typing import Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core.scheduler.job import Job

#: rows per vectorized batch in the streaming generators.  Part of the
#: sampling contract: draws are batched per chunk, so changing it changes
#: which variates each row receives (not their distribution).
TRACE_CHUNK_ROWS = 8192


def poisson_arrivals(jobs: Sequence[Job], rate_per_s: float,
                     seed: int = 0, start: float = 0.0) -> list[Job]:
    """Stamp i.i.d. exponential inter-arrival gaps (open-loop Poisson).

    Vectorized, and bitwise-equal to the scalar ``t += rng.exponential()``
    loop it replaced (see module docstring) — arrival-seeded goldens hold.
    """
    jobs = list(jobs)
    if not jobs:
        return jobs
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=len(jobs))
    stamps = np.cumsum(np.concatenate(([start], gaps)))[1:]
    for job, t in zip(jobs, stamps):
        job.arrival = float(t)
    return jobs


def diurnal_arrivals(jobs: Sequence[Job], period_s: float,
                     peak_rate: float, trough_rate: float,
                     seed: int = 0, phase_s: float = 0.0,
                     exact: bool = False) -> list[Job]:
    """Non-homogeneous Poisson with a sinusoidal day/night rate, sampled by
    thinning: candidates at the peak rate, accepted with probability
    lambda(t)/peak.  ``phase_s`` shifts the zone's local clock — a cluster
    stamps each zone's arrivals with its own offset so the zones' "days"
    interleave (follow-the-sun routing exploits exactly that stagger).

    The default path thins whole candidate batches at once; ``exact=True``
    runs the original per-candidate scalar loop, whose RNG stream the
    batched draws cannot reproduce (each candidate interleaves one
    exponential with one uniform draw).  Both are deterministic per seed.
    """
    if not 0.0 < trough_rate <= peak_rate:
        raise ValueError("need 0 < trough_rate <= peak_rate")
    rng = np.random.default_rng(seed)
    jobs = list(jobs)
    if exact:
        t = 0.0
        for job in jobs:
            while True:
                t += float(rng.exponential(1.0 / peak_rate))
                # rate bottoms out at local t=0 ("night"), peaks half a
                # period later; phase_s maps global sim time to zone-local
                lam = trough_rate + (peak_rate - trough_rate) * 0.5 * (
                    1.0 - math.cos(2.0 * math.pi * (t + phase_s) / period_s))
                if float(rng.uniform(0.0, peak_rate)) <= lam:
                    break
            job.arrival = t
        return jobs

    accepted: list[float] = []
    t = 0.0
    while len(accepted) < len(jobs):
        m = max(256, 2 * (len(jobs) - len(accepted)))
        cand = t + np.cumsum(rng.exponential(1.0 / peak_rate, size=m))
        lam = trough_rate + (peak_rate - trough_rate) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * (cand + phase_s) / period_s))
        keep = rng.uniform(0.0, peak_rate, size=m) <= lam
        accepted.extend(cand[keep].tolist())
        t = float(cand[-1])   # the clock runs through rejected candidates
    for job, ta in zip(jobs, accepted):
        job.arrival = ta
    return jobs


# -- Alibaba-style trace replay ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceRow:
    """One task of a cluster-trace-gpu-v2020-style trace."""

    job_id: str
    submit_time: float       # seconds from trace start
    duration: float          # seconds of execution at full request
    gpu_request: float       # fractional GPUs requested (0.25, 0.5, 1, ...)
    mem_gb: float            # device memory requested


def _parse_alibaba_record(rec: dict, i: int, time_scale: float,
                          gpu_mem_gb: float, gpu_unit: str,
                          seen: Counter) -> TraceRow:
    submit = float(rec.get("submit_time") or rec.get("start_time")
                   or 0.0)
    duration = float(rec.get("duration") or rec.get("runtime") or 0.0)
    plan_gpu = float(rec.get("plan_gpu") or rec.get("gpu")
                     or (100.0 if gpu_unit == "percent" else 1.0))
    gpu_frac = plan_gpu / 100.0 if gpu_unit == "percent" else plan_gpu
    mem = rec.get("plan_mem") or rec.get("cap_mem")
    mem_gb = float(mem) if mem else max(0.5, gpu_frac * gpu_mem_gb)
    job_id = str(rec.get("job_id") or rec.get("job_name") or i)
    # real traces repeat job_id across tasks; keep names unique so the
    # orchestrator's per-name completion accounting stays sound
    n = seen[job_id]
    seen[job_id] += 1
    if n:
        job_id = f"{job_id}#{n}"
    return TraceRow(
        job_id=job_id,
        submit_time=submit * time_scale,
        duration=max(duration * time_scale, 1e-3),
        gpu_request=min(max(gpu_frac, 0.01), 1.0),
        mem_gb=mem_gb)


def _check_gpu_unit(gpu_unit: str) -> None:
    if gpu_unit not in ("percent", "fraction"):
        raise ValueError(f"gpu_unit must be 'percent' or 'fraction', "
                         f"got {gpu_unit!r}")


def load_alibaba_csv(path: str, time_scale: float = 1.0,
                     gpu_mem_gb: float = 40.0,
                     gpu_unit: str = "percent") -> list[TraceRow]:
    """Load rows from a ``cluster-trace-gpu-v2020`` style CSV.

    Accepts the common column spellings (``submit_time``/``start_time`` in
    seconds, ``duration``/``runtime``, ``plan_gpu``, ``plan_mem`` in GB or
    ``cap_mem``); unknown memory falls back to the GPU-fraction share of
    ``gpu_mem_gb``.  ``gpu_unit`` says how ``plan_gpu`` is encoded —
    ``"percent"`` (the raw trace: 50 = half a GPU) or ``"fraction"``
    (0.5 = half a GPU); there is no reliable per-row heuristic, so it is
    explicit.  ``time_scale`` compresses trace time (the raw traces span
    days).
    """
    _check_gpu_unit(gpu_unit)
    seen: Counter = Counter()
    with open(path, newline="") as fh:
        rows = [_parse_alibaba_record(rec, i, time_scale, gpu_mem_gb,
                                      gpu_unit, seen)
                for i, rec in enumerate(csv.DictReader(fh))]
    rows.sort(key=lambda r: r.submit_time)
    return rows


def iter_alibaba_csv(path: str, time_scale: float = 1.0,
                     gpu_mem_gb: float = 40.0,
                     gpu_unit: str = "percent") -> Iterator[TraceRow]:
    """Streaming :func:`load_alibaba_csv`: yields rows as the file is read,
    never holding the trace in memory.  The file must already be sorted by
    submit time (the published traces are; :func:`load_alibaba_csv` sorts
    after loading) — an out-of-order row raises rather than silently
    corrupting replay order."""
    _check_gpu_unit(gpu_unit)
    seen: Counter = Counter()
    last = -math.inf
    with open(path, newline="") as fh:
        for i, rec in enumerate(csv.DictReader(fh)):
            row = _parse_alibaba_record(rec, i, time_scale, gpu_mem_gb,
                                        gpu_unit, seen)
            if row.submit_time < last:
                raise ValueError(
                    f"{path}: row {i} ({row.job_id!r}) submits at "
                    f"{row.submit_time} after {last} — sort the trace or "
                    f"use load_alibaba_csv")
            last = row.submit_time
            yield row


def write_alibaba_csv(rows: Iterable[TraceRow], path: str) -> int:
    """Write rows as a ``cluster-trace-gpu-v2020``-style CSV (fractional
    ``plan_gpu``, ``plan_mem`` in GB).  ``repr`` float formatting makes the
    :func:`load_alibaba_csv` round-trip lossless; returns the row count."""
    n = 0
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["job_id", "submit_time", "duration",
                         "plan_gpu", "plan_mem"])
        for row in rows:
            writer.writerow([row.job_id, repr(row.submit_time),
                             repr(row.duration), repr(row.gpu_request),
                             repr(row.mem_gb)])
            n += 1
    return n


def iter_synthetic_alibaba_rows(n: int, seed: int = 0,
                                rate_per_s: float = 0.2,
                                gpu_mem_gb: float = 40.0,
                                ) -> Iterator[TraceRow]:
    """Streaming synthetic trace with the cluster-trace-gpu-v2020 signature
    shape: bursty Poisson submissions, log-normal (heavy-tailed) durations,
    and GPU requests concentrated on the fractional tiers {0.25, 0.5} with
    a full-GPU tail.  Draws are vectorized per :data:`TRACE_CHUNK_ROWS`
    chunk, so memory stays flat at any ``n``."""
    rng = np.random.default_rng(seed)
    tiers = np.array([0.125, 0.25, 0.5, 1.0])
    tier_p = np.array([0.35, 0.35, 0.20, 0.10])
    t = 0.0
    base = 0
    while base < n:
        m = min(TRACE_CHUNK_ROWS, n - base)
        stamps = t + np.cumsum(rng.exponential(1.0 / rate_per_s, size=m))
        gpus = rng.choice(tiers, size=m, p=tier_p)
        durations = np.exp(rng.normal(1.6, 0.9, size=m))  # median ~5s
        mems = np.maximum(0.5, gpus * gpu_mem_gb
                          * rng.uniform(0.6, 1.0, size=m))
        t = float(stamps[-1])
        for k in range(m):
            yield TraceRow(job_id=f"trace-{base + k}",
                           submit_time=float(stamps[k]),
                           duration=float(durations[k]),
                           gpu_request=float(gpus[k]),
                           mem_gb=float(mems[k]))
        base += m


def synthetic_alibaba_rows(n: int, seed: int = 0, rate_per_s: float = 0.2,
                           gpu_mem_gb: float = 40.0) -> list[TraceRow]:
    """Materialized :func:`iter_synthetic_alibaba_rows` (same rows)."""
    return list(iter_synthetic_alibaba_rows(n, seed=seed,
                                            rate_per_s=rate_per_s,
                                            gpu_mem_gb=gpu_mem_gb))


def _job_from_row(row: TraceRow, io_fraction: float) -> Job:
    compute_time = row.duration * (1.0 - io_fraction)
    return Job(
        name=f"{row.job_id}", mem_gb=row.mem_gb,
        t_kernel=compute_time * row.gpu_request,
        compute_demand=row.gpu_request,
        t_fixed=0.2, t_io=row.duration * io_fraction,
        io_bw_demand=min(0.9, 0.2 * row.gpu_request + 0.05),
        est_mem_gb=row.mem_gb, arrival=row.submit_time,
        size_class="trace")


def iter_jobs_from_trace(rows: Iterable[TraceRow],
                         io_fraction: float = 0.15) -> Iterator[Job]:
    """Lazily materialize trace rows as scheduler jobs — chain onto
    :func:`iter_synthetic_alibaba_rows` / :func:`iter_alibaba_csv` and feed
    ``EventKernel.run(..., stream=True)`` so a million-row trace exists in
    memory only as the jobs currently in flight."""
    for row in rows:
        yield _job_from_row(row, io_fraction)


def jobs_from_trace(rows: Iterable[TraceRow],
                    io_fraction: float = 0.15) -> list[Job]:
    """Materialize trace rows as static scheduler jobs: the requested GPU
    fraction becomes the job's usable parallelism, the trace duration its
    full-request execution time (split kernel/IO by ``io_fraction``)."""
    return [_job_from_row(row, io_fraction) for row in rows]
