"""One run of one cell: set-up, the measured window, the trace, the check.

A cell of ``BENCHMARK.json`` names a configuration (its file of sizes,
weight rules and the name of its model module under ``reference/``) and a
traffic mix (``mixes/<traffic>.json``); what belongs to the cell alone
(its batch, its MIG profile, its check) is in ``cells/<cell>.json``.  The run builds the weights on the device from the
seed (:mod:`portbench.weights`), one ``ServeEngine`` of the program on the
cell's MIG profile, warms it on one batch of the cell's own shape (which
captures the cell's one decode graph), and then, for the window's seconds,
hands the engine one fresh batch after another, each due when the
previous one returns: a closed loop, as an offline batch job on a slice
runs.  Batches start while the window's time is not up; the window ends
when the last one returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, devtrace, traffic, weights as weight_maker
from portbench.reference.control import fp8

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
GIB = 1024 ** 3


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration's file
    reference: object   # reference/<module>.py that the configuration names
    mix: dict           # mixes/<traffic>.json
    cell: dict          # cells/<name>.json
    end_to_end: list[str]
    per_layer: list[str]
    units: dict[str, str]   # every metric's unit, by name


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files found
    by the names given there."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    wl = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    here = root / HERE.name
    config = json.loads((root / conf["file"]).read_text())
    return Cell(
        name=name, chips=wl["chips"], config=config,
        reference=load(here / "reference" / f"{config['reference']}.py",
                       f"portbench.reference.{config['reference']}"),
        mix=json.loads((here / "mixes" / f"{wl['traffic']}.json").read_text()),
        cell=json.loads((here / "cells" / f"{name}.json").read_text()),
        end_to_end=[m["name"] for m in bench["end_to_end"]
                    if _applies(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"]
                   if _applies(m, name)],
        units={m["name"]: m["unit"]
               for m in bench["end_to_end"] + bench["per_layer"]})


def load(path: Path, name: str):
    """The module of the file ``path``, under the name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load(root / HERE.name / "metrics" / f"{metric}.py",
                f"portbench.metrics.{metric}").read


@dataclasses.dataclass
class Batch:
    """A batch as the traced records see it."""
    prompts: list[int]
    generated: list[int]
    padded: int
    size: int


@dataclasses.dataclass
class Records:
    """What the per-layer readers read: the reduced trace of the traced
    batches, those batches, the configuration's ``model`` block and its
    model module (:mod:`portbench.reference`)."""
    trace: devtrace.Trace
    batches: list[Batch]
    model: dict
    reference: object


@dataclasses.dataclass
class Outcome:
    """A run's result line (without ``correct``) and the numbers compared,
    each with its limit; ``control`` is the control's widest gap on the
    same sample, where it was asked for."""
    result: dict
    checks: dict
    control: float | None = None

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


@dataclasses.dataclass
class Done:
    """One batch of the window: its requests, the seconds its ``run()``
    took (None where it raised), and the logits of its prefill."""
    requests: list
    seconds: float | None
    prefill_logits: torch.Tensor | None


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float, energy=None,
        control: bool = False) -> Outcome:
    """One run of ``cell``; ``started`` is the host clock's reading when
    the process began, ``energy`` the card's energy counter (None off the
    card).  With ``control`` the control is read on the check's sample
    too (the benchmark's own runs never do)."""
    from repro_torch.models import registry

    prefills = PrefillLogits(registry)
    registry.prefill_caches = prefills
    try:
        return _run(cell, seed, seconds, trace, device, started, energy,
                    prefills, control)
    finally:
        registry.prefill_caches = prefills.original


def _run(cell, seed, seconds, trace, device, started, energy, prefills,
         control):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.mig_h100 import MigH100Backend
    from repro_torch.core.restart import NeedsLargerPartition
    from repro_torch.models import registry
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    seed %= 2 ** 63
    on_card = device.type == "cuda"
    m = cell.config["model"]
    cfg = ModelConfig(**m)
    batch_size = cell.cell["batch"]

    # -- set-up -------------------------------------------------------------
    t_weights = time.perf_counter()
    shapes, _ = registry.init_params(None, cfg, "meta")
    params = weight_maker.make(shapes, cell.config["weights"], seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    t_engine = time.perf_counter()
    backend = MigH100Backend()
    profile = {p.name: p for p in backend.profiles}[cell.cell["mig_profile"]]
    engine = ServeEngine(cfg, params, EngineConfig(
        max_batch=batch_size, max_context=traffic.context(cell.mix),
        partition_gb=profile.mem_gb, predict=True),
        backend=backend, device=device)
    uid = itertools.count()

    def requests(plan, most_new=None):
        return [Request(uid=next(uid), prompt=p.prompt,
                        max_new_tokens=min(p.max_new_tokens,
                                           most_new or p.max_new_tokens))
                for p in plan]

    # one batch of the cell's own shape: its prefill at the padded length,
    # and the capture of its decode graph with two steps on it
    warm = traffic.Traffic(cell.mix, batch_size, cfg.vocab, seed, stream=0)
    engine.run(requests(warm.batch(), most_new=2))
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    # the set-up's objects out of the collector's scans, so that a
    # collection inside the window walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started
    print(f"portbench: set-up {setup_s:.3f} s: until the weights "
          f"{t_weights - started:.3f} s, the weights "
          f"{t_engine - t_weights:.3f} s, the warm-up batch "
          f"{time.perf_counter() - t_engine:.3f} s", file=sys.stderr)

    # -- the window ---------------------------------------------------------
    gen = traffic.Traffic(cell.mix, batch_size, cfg.vocab, seed, stream=1)
    done: list[Done] = []
    prof = None
    mj0 = energy.millijoules() if energy else None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        reqs = requests(gen.batch())
        traced = trace and not done
        mark = len(prefills.logits)
        with (profiler() if traced else contextlib.nullcontext()) as p:
            tb = time.perf_counter()
            try:
                with torch.profiler.record_function(devtrace.BATCH_SPAN):
                    engine.run(reqs)
                spent = time.perf_counter() - tb
            except NeedsLargerPartition:
                spent = None
        if traced:
            prof = p
        done.append(Done(reqs, spent, (prefills.logits[mark]
                                         if len(prefills.logits) > mark
                                         else None)))
    window_s = time.perf_counter() - t0
    mj1 = energy.millijoules() if energy else None

    ok = [b for b in done if b.seconds is not None]
    print(f"portbench: window {window_s:.3f} s, {len(done)} batches, "
          f"run() seconds {[round(b.seconds, 4) for b in ok]}",
          file=sys.stderr)
    attempted = sum(len(b.requests) for b in done)
    failed = attempted - sum(len(b.requests) for b in ok)
    tokens = sum(len(r.generated) for b in ok for r in b.requests)
    latencies = [b.seconds / len(r.generated) * 1e3 for b in ok
                 for r in b.requests if r.generated]
    metrics = {"setup_s": setup_s}
    if tokens:
        metrics["output_tokens_per_s"] = tokens / window_s
        metrics["norm_latency_p90_ms"] = float(np.percentile(latencies, 90))
        if mj0 is not None:
            metrics["joules_per_token"] = (mj1 - mj0) / 1e3 / tokens
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else device.type),
                   "count": 1}
    if on_card:
        window_peak = torch.cuda.max_memory_allocated(device)
        metrics["peak_mem_gib"] = window_peak / GIB
        device_info["memory_peak_bytes"] = max(setup_peak, window_peak)

    result = {"attempted": attempted, "failed": failed}
    if trace:
        records = traced_records(prof, done[0], m, cell.reference)
        lo, hi = records.trace.window
        device_info["busy_s"] = devtrace.busy_ns(records.trace) / 1e9
        device_info["window_s"] = (hi - lo) / 1e9
        values = {name: reader(name)(records) for name in cell.per_layer}
        metrics = {k: v for k, v in values.items() if v is not None}
        result["breakdown"] = devtrace.breakdown(records.trace)
        del prof, records
    result["metrics"] = {name: {"value": metrics[name],
                                "unit": cell.units[name]}
                         for name in (cell.per_layer if trace
                                      else cell.end_to_end)
                         if name in metrics}
    result["device"] = device_info

    # -- the check, once the program's state is freed -------------------------
    chosen = [check.Chosen(r.prompt, max(len(x.prompt) for x in b.requests),
                           [first] + list(r.generated))
              for b in ok
              for first, r in zip(first_tokens(b.prefill_logits, cfg.vocab),
                                  b.requests)]
    engine.decoders.clear()
    del engine, done, ok, prefills.logits[:]
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    gap, control_gap = judge(params, cell, chosen, seed, device, control)
    return Outcome(result, {
        "failed_requests": {"value": failed, "limit": 0},
        "logit_gap": {"value": gap, "limit": cell.cell["check"]["limit"]}},
        control_gap)


class PrefillLogits:
    """A wrapper around ``registry.prefill_caches`` that keeps the logits
    of every prefill (on the device, unread): the engine takes each
    request's first token from them and does not return it."""

    def __init__(self, registry) -> None:
        self.original = registry.prefill_caches
        self.logits: list[torch.Tensor] = []

    def __call__(self, *args, **kwargs):
        out = self.original(*args, **kwargs)
        self.logits.append(out[0])
        return out


def first_tokens(logits: torch.Tensor, vocab: int) -> list[int]:
    """The first tokens of a batch, chosen from its prefill's logits as
    the engine chooses them."""
    return torch.argmax(logits[:, -1, :vocab], dim=-1).tolist()


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def traced_records(prof, first: Done, model: dict, reference) -> Records:
    reqs = first.requests
    padded = max(len(r.prompt) for r in reqs)
    return Records(devtrace.reduce(prof),
                   [Batch([len(r.prompt) for r in reqs],
                          [len(r.generated) for r in reqs], padded,
                          len(reqs))], model, reference)


#: the gap reported when no request was served: above any limit
NOTHING_SERVED = 1e9


def judge(params: dict, cell: Cell, chosen: list, seed: int,
          device: torch.device, control: bool = False
          ) -> tuple[float, float | None]:
    """The widest logit gap of a sample of the chosen tokens
    (``NOTHING_SERVED`` where nothing was served) and, with ``control``,
    that of the tokens the control puts first on the same rows."""
    spec, m = cell.cell["check"], cell.config["model"]
    rows = check.sample(chosen, np.random.default_rng([seed, 2]),
                        spec["tokens"], spec["rows"])
    if not rows:
        return NOTHING_SERVED, None
    check.precise_matmuls()
    ref_logits = check.logits_at(cell.reference, params, m, rows, device)
    gap = check.widest_gap(ref_logits, check.chosen_tokens(rows, device))
    if not control:
        return gap, None
    low = check.logits_at(cell.reference, params, m, rows, device, cast=fp8)
    return gap, check.widest_gap(ref_logits, low.argmax(dim=-1))
