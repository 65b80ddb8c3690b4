"""Multi-tenant MIG serving — the paper's system live on one H100.

    PYTHONPATH=src python -m repro_torch.launch.multi_tenant \
        [--device cuda|cpu] [--smoke] [--seed 0]

The port of the reference's ``examples/multi_tenant.py``, on the card the
paper itself used:

  1. the card is managed by the H100 MIG FSM (:mod:`repro_torch.core.mig_h100`)
     through :class:`~repro_torch.core.partition_manager.PartitionManager`;
  2. three tenants (decode jobs of qwen3-0.6b on one set of weights) each
     lease the tightest profile holding 1.3x the weights, at Algorithm 3's
     argmax-reachability placement, before any of them runs; the tenants
     then run one after another, each on its lease;
  3. the growing tenant's :class:`MemoryAccountant` and time-series
     predictor raise :class:`NeedsLargerPartition` once the converged peak
     exceeds its lease; the job restarts early, with no checkpoint, on the
     next larger profile (the paper's §2.3 flow).

How a lease is enforced.  Creating MIG instances needs administrator rights
and a reset of the card, so the port does not create them: it prints the
card's MIG mode and any MIG devices ``nvidia-smi`` lists, and asks for
nothing more.  Instead each run caps the process's CUDA caching allocator
at its lease (:func:`memory_lease`), so a tenant whose real footprint
outgrows the lease fails with a real CUDA out-of-memory error, which
nothing here catches.  The cap isolates memory only: every tenant runs on
all of the card's SMs, where a MIG instance would have its profile's GPCs.

The accountant is fed the reference's synthetic series (:func:`live_bytes`):
the weights plus the used prefix of the KV cache, times a growth factor
that rises from 1 to ~100 over the growing tenant's run.  The reference
runs every tenant at batch 1 in a context of 256; at full width that
tenant would peak near 1.6 GiB, far below a 10 GB slice, so the full-width
growing tenant runs a larger batch and context (:data:`GROWING`).  Like the
reference, this path only decodes, so it reaches no kernel of
:mod:`repro_torch.kernels`; on the card each run replays a decode step
captured for it, as the reference jits its step once per slice.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import time

import torch

from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.core.memory.accountant import MemoryAccountant, pytree_nbytes
from repro_torch.core.memory.timeseries import PeakMemoryPredictor, Prediction
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.partition_manager import Partition, PartitionManager
from repro_torch.core.partition_state import PartitionProfile
from repro_torch.core.restart import NeedsLargerPartition
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving.decode_graph import decoder_for

ARCH = "qwen3-0.6b"


@dataclasses.dataclass
class TenantJob:
    name: str
    n_tokens: int           # decode steps to run
    growing: bool = False   # context growth -> predictor watches it
    batch: int = 1
    context: int = 256      # cache length; the used prefix divides by it


#: the full-width growing tenant: its formula peak (1.11 GiB of weights plus
#: 3.5 GiB of bf16 cache times ~99.2 x 128 / 4096) is ~12.0 GiB, so the
#: predictor flags a 1g.10gb lease before the last step and the regrown run
#: fits 1g.20gb (tests/test_torch_multi_tenant.py feeds it the series)
GROWING = TenantJob("tenant-c-growing", 128, growing=True, batch=8,
                    context=4096)


def make_jobs(smoke: bool) -> list[TenantJob]:
    """The reference's three tenants; at full width the growing one is
    :data:`GROWING`."""
    growing = (TenantJob("tenant-c-growing", 48, growing=True) if smoke
               else GROWING)
    return [TenantJob("tenant-a", 24), TenantJob("tenant-b", 24), growing]


def live_bytes(job: TenantJob, i: int, params_b: int, cache_b: int) -> float:
    """Step ``i``'s live bytes as the reference feeds its accountant: the
    weights plus the used prefix of the cache (synthetic growth for the
    growing tenant, to emulate a long context)."""
    grow = (1.0 + 99.0 * i / job.n_tokens) if job.growing else 1.0
    return params_b + cache_b * grow * (i + 1) / job.context


def run_job_on_slice(job: TenantJob, cfg: ModelConfig, params: dict,
                     device: torch.device, partition_gb: float,
                     predictor=None) -> list[int]:
    """Run a greedy decode loop on ``device``; returns the first request's
    tokens or raises NeedsLargerPartition when the predictor flags the
    growth against ``partition_gb``.  On the card the loop replays a decode
    step captured for this run (:func:`decoder_for`), so a restart on a new
    slice captures anew, as the reference re-jits on its new slice; the
    graph's memory pool counts against the lease."""
    decoder = decoder_for(params, cfg, job.batch, job.context, device)
    acc = MemoryAccountant()
    tok = torch.zeros((job.batch, 1), dtype=torch.long, device=device)
    out = []
    params_b = pytree_nbytes(params)
    cache_b = pytree_nbytes(decoder.caches)
    with torch.inference_mode():
        for i in range(job.n_tokens):
            logits = decoder.step(tok, i)
            tok = torch.argmax(logits[:, :, :cfg.vocab], dim=-1)
            out.append(int(tok[0, 0]))
            live = live_bytes(job, i, params_b, cache_b)
            acc.note_alloc(live * 0.1 + params_b * 0.01)
            acc.note_live(live)
            acc.end_iteration()
            if predictor is not None:
                stats = acc.history[-1]
                pred = predictor.observe(stats.requested_bytes,
                                         stats.reuse_ratio)
                if predictor.will_oom(partition_gb * 1024 ** 3, pred):
                    raise NeedsLargerPartition(None)
    return out


class FlaggingPredictor(PeakMemoryPredictor):
    """The growing tenant's predictor; keeps the prediction it flagged."""

    flagged: Prediction | None = None

    def will_oom(self, partition_bytes: float, pred: Prediction,
                 require_converged: bool = True) -> bool:
        hit = super().will_oom(partition_bytes, pred, require_converged)
        if hit:
            self.flagged = pred
        return hit


@contextlib.contextmanager
def memory_lease(device: torch.device, lease_gb: float):
    """Cap the process's CUDA caching allocator at ``lease_gb`` (GiB, as
    the predictor counts a lease) for the body, and reset its peak; the
    cap is lifted on the way out, whatever the body raised.  A no-op off
    the card."""
    if device.type != "cuda":
        yield
        return
    if device.index is None:          # the allocator's calls need an index
        device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(device).total_memory
    torch.cuda.set_per_process_memory_fraction(
        min(1.0, lease_gb * 1024 ** 3 / total), device)
    torch.cuda.reset_peak_memory_stats(device)
    try:
        yield
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, device)


def mig_report() -> list[str]:
    """The card's MIG mode and any MIG devices, as nvidia-smi lists them."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=mig.mode.current",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    listing = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    return ([f"MIG mode: {(mode.stdout or mode.stderr).strip()}"]
            + [line.strip() for line in listing.stdout.splitlines()
               if "MIG-" in line])


@dataclasses.dataclass
class SliceRun:
    """One run of a tenant on one lease."""

    profile: str
    gpc: int
    lease_gb: float
    steps: int = 0
    ms_per_step: float = 0.0           # host ms a decode step, caches incl.
    peak_gb: float | None = None       # allocator peak (GiB), card only
    flagged: Prediction | None = None  # the predictor's early-restart call


@dataclasses.dataclass
class TenantRun:
    """A tenant's leases and runs, in order, and its finished tokens."""

    job: TenantJob
    reach: int                         # card reachability after its lease
    slices: list[SliceRun] = dataclasses.field(default_factory=list)
    tokens: list[int] = dataclasses.field(default_factory=list)


def _run_slice(run: TenantRun, cfg: ModelConfig, params: dict,
               device: torch.device, profile: PartitionProfile,
               part: Partition, predictor) -> list[int] | None:
    """Run ``run.job`` once under its lease, recording the run; the tokens,
    or None when the predictor flagged the lease (the exception is dropped
    here, so the run's caches are freed before any restart)."""
    rec = SliceRun(profile.name, part.handle[0], profile.mem_gb)
    run.slices.append(rec)
    tokens = None
    t0 = time.perf_counter()
    try:
        with memory_lease(device, profile.mem_gb):
            tokens = run_job_on_slice(run.job, cfg, params, device,
                                      profile.mem_gb, predictor)
    except NeedsLargerPartition:
        rec.flagged = predictor.flagged
    rec.steps = len(tokens) if tokens is not None else \
        rec.flagged.iteration + 1
    rec.ms_per_step = (time.perf_counter() - t0) * 1e3 / rec.steps
    if device.type == "cuda":
        rec.peak_gb = torch.cuda.max_memory_allocated(device) / 1024 ** 3
    return tokens


def run_tenants(cfg: ModelConfig, params: dict, jobs: list[TenantJob],
                device: str | torch.device, log=print
                ) -> tuple[PartitionManager, list[TenantRun]]:
    """Lease a tight slice per tenant first, then run each on its lease,
    restarting a flagged tenant early on the next larger profile.  Returns
    the partition manager (empty again at the end) and the tenants' runs."""
    device = torch.device(device)
    if device.type == "cuda":
        for line in mig_report():
            log(f"[multi_tenant] {line}")
    backend = MigH100Backend()
    pm = PartitionManager(backend)

    # lease a tight slice per tenant FIRST — three co-resident partitions,
    # each placement chosen by Alg. 3's reachability argmax
    need_gb = pytree_nbytes(params) / 1024 ** 3 * 1.3
    leases = []
    for job in jobs:
        profile = backend.tightest_profile(need_gb)
        part = pm.allocate(profile) or pm.allocate_with_reshape(profile)
        if part is None:
            raise RuntimeError(f"no slice for {job.name}")
        run = TenantRun(job, reach=backend.reachability(pm.state))
        leases.append((run, profile, part))
        log(f"[multi_tenant] {job.name}: leased {profile.name} at GPC "
            f"{part.handle[0]}  (card reachability now {run.reach})")
    log(f"[multi_tenant] card state with {len(jobs)} tenants: "
        f"{pm.describe()}")

    for run, profile, part in leases:
        job = run.job
        predictor = (FlaggingPredictor(max_iter=job.n_tokens,
                                       converge_tol=0.3)
                     if job.growing else None)
        tokens = _run_slice(run, cfg, params, device, profile, part,
                            predictor)
        if tokens is None:
            # the paper's early restart: free the tight slice, re-place on
            # the next larger one and run again — no checkpoint files
            flag = run.slices[-1].flagged
            pm.release(part)
            profile = backend.next_larger_profile(profile)
            part = pm.allocate(profile) or pm.allocate_with_reshape(profile)
            if part is None:
                raise RuntimeError(f"no {profile.name} slice to restart "
                                   f"{job.name} on")
            log(f"[multi_tenant] {job.name}: predictor flagged step "
                f"{flag.iteration} (peak "
                f"{flag.peak_mem_bytes / 1024 ** 3:.3f} GiB) -> EARLY "
                f"RESTART on {profile.name} at GPC {part.handle[0]}")
            tokens = _run_slice(run, cfg, params, device, profile, part,
                                None)
        run.tokens = tokens
        pm.release(part)
        last = run.slices[-1]
        peak = ("" if last.peak_gb is None
                else f", allocator peak {last.peak_gb:.3f} of "
                     f"{last.lease_gb:.0f} GiB")
        log(f"[multi_tenant]   done: {len(tokens)} tokens on {last.profile}, "
            f"{last.ms_per_step:.2f} ms/step{peak}, first 8: {tokens[:8]}")
    log(f"[multi_tenant] final state: {pm.describe()} (back to an empty "
        f"card: {pm.state == backend.initial_state()})")
    return pm, [run for run, _, _ in leases]


def main(argv: list[str] | None = None) -> PartitionManager:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(ARCH) if args.smoke else get_config(ARCH)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params, _ = registry.init_params(gen, cfg)
    jobs = make_jobs(args.smoke)
    grower = jobs[-1]
    params_b = pytree_nbytes(params)
    cache_b = pytree_nbytes(registry.init_caches(cfg, grower.batch,
                                                 grower.context, "meta"))
    peak_gb = live_bytes(grower, grower.n_tokens - 1, params_b,
                         cache_b) / 1024 ** 3
    print(f"[multi_tenant] {cfg.name} on {device}: weights "
          f"{params_b / 1024 ** 3:.3f} GiB; {grower.name} at batch "
          f"{grower.batch}, context {grower.context}, {grower.n_tokens} "
          f"tokens, formula peak {peak_gb:.2f} GiB")
    pm, _ = run_tenants(cfg, params, jobs, device)
    return pm


if __name__ == "__main__":
    main()
