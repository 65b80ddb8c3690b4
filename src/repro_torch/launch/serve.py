"""Serving entry point: batched greedy decoding with the paper's memory watch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        [--smoke] --requests 4 --prompt-len 8 --max-new 32 \
        [--partition-gb 10] [--device cuda] [--trace serve.jsonl]

Runs on the card (``--device cuda``, the default) on an H100 MIG backend,
with the prefill on the hand-written kernels: flash attention for the
dense and VLM models (``--arch`` qwen3-0.6b, qwen3-1.7b, gemma-2b, whose
head dim 256 and single KV head take the kernel's D=256 code, gemma3-27b,
whose local layers pass their sliding window to the kernel, and
pixtral-12b, served on text tokens as the reference's engine serves it)
and for the decoder of the whisper encoder-decoder (``--arch
whisper-medium``, whose encoder runs first, plain, on zero frames as the
reference's engine gives it), the SSD chunk scan for mamba2 (``--arch
mamba2-2.7b``), both for the zamba2 hybrid (``--arch zamba2-7b``).  The
MoE configs (``--arch grok-1-314b``, whose every layer goes to the flash
kernel, and ``llama4-maverick-400b-a17b``, whose global layers do while
its chunked local layers stay plain) route each prompt and decode token
to its experts as a group of one; at full depth they hold 588 and 739 GiB
of bf16 weights, more than one 80 GB card holds (``--smoke`` serves their
smoke configs anywhere; chip_smoke.py and profile_serve.py serve them on
one card cut to the depths of ``configs.ONE_CARD_LAYERS``).  With
``--partition-gb`` the engine runs the time-series predictor against that
slice size and performs the early restart (regrow to the profile the
predictor asks for) when the converged peak estimate exceeds it.  With
``--trace PATH`` every engine of the restart loop records its spans and
counters into one wall-clock :class:`~repro_torch.obs.trace.Tracer`
streaming to ``PATH`` (JSONL); the Chrome trace goes beside it
(``.chrome.json``), and one ``[serve] trace:`` line sums up the served
batch's run: time to first token, the median and p90 gap between tokens,
the host ms a decode step in each span, the padding and done-row shares,
the accountant's peak over the allocator's, the restarts, and for a model
with routed experts the decode steps' expert rows routed and computed.
``--arch granite-4.0-h-small`` serves IBM Granite 4.0-H Small (Mamba2 and
NoPE attention layers, each with a 72-expert MoE and a shared expert; the
SSD and flash kernels in the prefill): 60 GiB of bf16 weights at its full
40 layers, so its ``--smoke`` config is the one for a small run.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.bridge import load_npz_params
from repro_torch.configs import (ModelConfig, SERVED_ARCHS, get_config,
                                 get_smoke_config)
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.partition_state import PartitionBackend
from repro_torch.core.restart import NeedsLargerPartition
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.obs.trace import Tracer, read_jsonl, write_chrome_trace
from repro_torch.serving.engine import (SPAN, EngineConfig, Request,
                                        ServeEngine)

#: the per-step spans whose host ms the trace summary gives
STEP_SPANS = ("launch", "sync", "tokens", "memory")


def make_requests(cfg: ModelConfig, n: int, prompt_len: int, max_new: int,
                  seed: int) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, prompt_len
                                        ).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


def serve(cfg: ModelConfig, params: dict, requests: list[Request], *,
          max_context: int, partition_gb: float | None,
          backend: PartitionBackend, device: str | torch.device,
          log=print, tracer: Tracer | None = None
          ) -> tuple[ServeEngine, list[Request], list[str]]:
    """The early-restart regrow loop: run the batch on a slice of
    ``partition_gb``; on :class:`NeedsLargerPartition` regrow to the
    profile it carries and run again.  Every engine records into
    ``tracer``.  Returns (engine, requests, the restart lines)."""
    restarts: list[str] = []
    profile_gb = partition_gb
    while True:
        engine = ServeEngine(cfg, params,
                             EngineConfig(max_batch=len(requests),
                                          max_context=max_context,
                                          partition_gb=profile_gb,
                                          predict=profile_gb is not None),
                             backend=backend, device=device, tracer=tracer)
        for r in requests:
            r.generated.clear()
        try:
            return engine, engine.run(requests), restarts
        except NeedsLargerPartition as e:
            nxt = e.profile or backend.tightest_profile(
                (profile_gb or 1.0) * 2)
            line = (f"[serve] EARLY RESTART: predictor flagged the "
                    f"{profile_gb:.1f}GB slice -> regrowing to "
                    f"{nxt.name} ({nxt.mem_gb:.1f}GB)")
            log(line)
            restarts.append(line)
            profile_gb = nxt.mem_gb


def trace_summary(records: list[dict]) -> dict:
    """The served batch's figures from a wall trace of the restart loop:
    its last ``run`` span (the one that returned) and the counters it
    ended with, and the restarts of every run."""
    spans = [r for r in records if r["type"] == "span"]
    run = [r for r in spans if r["name"] == SPAN + "run"][-1]
    inside = [r for r in spans
              if run["t0"] <= r["t0"] and r["t1"] <= run["t1"]]
    counters: dict[str, list[float]] = {}
    for r in records:
        if r["type"] == "counter":
            counters.setdefault(r["name"][len(SPAN):], []).append(r["value"])
    last = {name: values[-1] for name, values in counters.items()}

    def stage(name):
        return [r for r in inside if r["name"] == SPAN + name]

    syncs = [r["t1"] for r in stage("sync")]
    gaps_ms = np.diff(syncs) * 1e3
    peak = last.get("allocator_peak_bytes")
    return {
        "ttft_ms": (syncs[0] - run["t0"]) * 1e3 if syncs else None,
        "gap_p50_ms": float(np.median(gaps_ms)) if len(gaps_ms) else None,
        "gap_p90_ms": (float(np.percentile(gaps_ms, 90)) if len(gaps_ms)
                       else None),
        "host_ms_per_step": {
            name: (float(np.mean([r["t1"] - r["t0"] for r in stage(name)]))
                   * 1e3 if stage(name) else None)
            for name in STEP_SPANS},
        "padding_share": last["padding_tokens"] / (
            run["args"]["batch"] * run["args"]["padded"]),
        "done_row_share": (last["decode_rows_done"]
                           / last["decode_row_steps"]
                           if last["decode_row_steps"] else None),
        "accountant_over_allocator": (last["accountant_peak_bytes"] / peak
                                      if peak else None),
        "restarts": int(sum(counters["restarts"])),
        "moe_routed_rows": last.get("moe_routed_rows"),
        "moe_expert_rows": last.get("moe_expert_rows"),
    }


def _fmt(value, spec: str = ".3f") -> str:
    return "n/a" if value is None else format(value, spec)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=SERVED_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-context", type=int, default=256)
    ap.add_argument("--partition-gb", type=float, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the engines' spans and counters to PATH "
                    "(JSONL) and its Chrome trace beside it")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas", ssm_impl="pallas")
    print(f"[serve] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"family={cfg.family} on {device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params, _ = registry.init_params(gen, cfg)
    if args.ckpt:
        params = load_npz_params(args.ckpt, cfg, device)
        print(f"[serve] weights from {args.ckpt}")

    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         args.seed)
    tracer = (Tracer.wall({"arch": cfg.name, "device": str(device)},
                          sink=args.trace) if args.trace else None)
    t0 = time.perf_counter()
    try:
        engine, out, _ = serve(cfg, params, reqs,
                               max_context=args.max_context,
                               partition_gb=args.partition_gb,
                               backend=MigH100Backend(), device=device,
                               tracer=tracer)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        if tracer is not None:
            tracer.finish(tracer.wall_seconds(time.time_ns()))
            tracer.close()
    n_tok = sum(len(r.generated) for r in out)
    print(f"[serve] {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s)")
    for r in out[:4]:
        print(f"  req {r.uid}: {r.generated[:16]}"
              f"{'...' if len(r.generated) > 16 else ''}")
    peak = engine.accountant.peak_in_use / 1024 ** 3
    print(f"[serve] peak live memory {peak:.3f} GB over "
          f"{len(engine.accountant.history)} iterations")
    if tracer is not None:
        header, records = read_jsonl(args.trace)
        chrome = Path(args.trace).with_suffix(".chrome.json")
        write_chrome_trace(str(chrome), records, header["meta"])
        t = trace_summary(records)
        host = ", ".join(f"{k} {_fmt(v)}"
                         for k, v in t["host_ms_per_step"].items())
        print(f"[serve] trace: ttft {_fmt(t['ttft_ms'])} ms, gap p50 "
              f"{_fmt(t['gap_p50_ms'])} ms p90 {_fmt(t['gap_p90_ms'])} ms, "
              f"host ms/step {host}, padding {_fmt(t['padding_share'])}, "
              f"done rows {_fmt(t['done_row_share'])}, accountant/allocator "
              f"peak {_fmt(t['accountant_over_allocator'])}, restarts "
              f"{t['restarts']}, moe rows routed/computed "
              f"{_fmt(t['moe_routed_rows'], 'd')}/"
              f"{_fmt(t['moe_expert_rows'], 'd')} ({args.trace}, {chrome})")


if __name__ == "__main__":
    main()
