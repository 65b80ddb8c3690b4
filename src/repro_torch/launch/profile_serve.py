"""Where the serving time goes on the card: prefill and decode under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen3-0.6b | qwen3-1.7b | gemma-2b | gemma3-27b |
                pixtral-12b | mamba2-2.7b | zamba2-7b | whisper-medium |
                grok-1-314b | llama4-maverick-400b-a17b]

Builds chip_smoke.py's serving configuration for the arch (full width,
random bf16 weights from seed 0, ``attn_impl`` and ``ssm_impl`` "pallas",
8 prompts of 512 tokens and context 1024; whisper-medium 8 prompts of 224
tokens and context 448; gemma3-27b 8 prompts of 1536 tokens and context
2048, so that its local layers cut their 1024-token window; the MoE
configs at phase 4f's depth, ``configs.ONE_CARD_LAYERS``, widths and
expert counts as published), then
profiles its windows, each after a warm-up:
for whisper-medium first the encoder (``registry.prefill_encoder`` over
zero frames, as the engine runs it); one ``registry.prefill_caches`` over
the prompt batch (the engine's prefill call); 16 decode steps as the
engine takes them on the card, each a replay of its captured graph
(:class:`~repro_torch.serving.decode_graph.DecodeGraph`, on caches the
same prefill filled), the greedy argmax and the copy of the tokens to the
host ("decode"); and beside them the same 16 steps run eagerly, op by op,
as the engine ran them before the graph (``registry.decode_step`` at an
``int`` position, MoE layers dropless: "decode_eager").  For each window it
prints the wall
time, the device's busy time (the union of its kernels' intervals, so
kernels that overlap count once), the device's busy share, the kernel
launches, and the kernels that take the most device time, and how many
launches were flash, SSD and copy kernels, then one JSON line.  It needs a
card and fails without one.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, ONE_CARD_LAYERS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving.decode_graph import DecodeGraph


def busy_ms(ranges) -> float:
    """Milliseconds covered by the union of ``(start_us, end_us)``
    intervals: kernels that overlap count once."""
    total = 0.0
    lo = hi = None
    for s, e in sorted(ranges):
        if hi is None or s > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    if hi is not None:
        total += hi - lo
    return total / 1e3


def _window(fn, device) -> dict:
    """Profile one call of fn: wall ms and the CUDA kernels it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    by_name: dict[str, float] = collections.defaultdict(float)
    named = dict.fromkeys(COUNTED, 0)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        for word in COUNTED:
            named[word] += word in e.name
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms, "launches": len(kernels),
            "launches_named": named,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


#: kernel launches counted by a word of their name: the flash kernels
#: (flash_fwd_kernel, flash_fwd_sm90_kernel), the SSD kernels
#: (ssd_scan_kernel, ssd_scan_sm90_kernel) and PyTorch's copy kernels
#: (direct_copy_kernel_cuda and the like, which layout changes launch)
COUNTED = ("flash", "ssd", "copy")
SEED = 0
REQUESTS, DECODE_STEPS = 8, 16
#: (prompt tokens, context) of each arch's serving phase in chip_smoke.py
SHAPES = {"whisper-medium": (224, 448), "gemma3-27b": (1536, 2048)}
DEFAULT_SHAPE = (512, 1024)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ALL_ARCHS)
    args = ap.parse_args()
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas", ssm_impl="pallas",
                              n_layers=ONE_CARD_LAYERS.get(cfg.name,
                                                          cfg.n_layers))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params, _ = registry.init_params(gen, cfg)
    prompt_len, max_context = SHAPES.get(cfg.name, DEFAULT_SHAPE)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (REQUESTS, prompt_len))).to(device)
    caches = registry.init_caches(cfg, REQUESTS, max_context, device)
    state = {}

    def encoder():
        frames = torch.zeros((REQUESTS, cfg.enc_seq, cfg.d_model),
                             dtype=torch.bfloat16, device=device)
        registry.prefill_encoder(params, cfg, {"frames": frames}, caches)

    def prefill():
        state["logits"], _ = registry.prefill_caches(params, cfg, tokens,
                                                     caches)

    def decode_loop(step):
        tok = torch.argmax(state["logits"][:, -1, :cfg.vocab], dim=-1)[:, None]
        for i in range(DECODE_STEPS):
            logits = step(tok, prompt_len + i)
            tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
            tok.cpu()

    def decode():
        decode_loop(graph.step)

    def decode_eager():
        decode_loop(lambda tok, pos: registry.decode_step(
            params, cfg, tok, pos, caches)[0])

    windows = {"prefill": prefill, "decode": decode,
               "decode_eager": decode_eager}
    if cfg.family == "audio":
        windows = {"encoder": encoder, **windows}
    with torch.inference_mode():
        graph = DecodeGraph(params, cfg, REQUESTS, max_context, device)
        if cfg.family == "audio":
            encoder()
            for name in ("cross_k", "cross_v"):
                graph.caches[name].copy_(caches[name])
        registry.prefill_caches(params, cfg, tokens, graph.caches)
        for fn in windows.values():   # warm-up of every window
            fn()
        out = {"card": torch.cuda.get_device_name(device),
               "capture_s": graph.capture_s,
               "config": {"arch": cfg.name, "layers": cfg.n_layers,
                          "requests": REQUESTS,
                          "prompt_len": prompt_len,
                          "max_context": max_context,
                          "decode_steps": DECODE_STEPS},
               **{name: _window(fn, device) for name, fn in windows.items()}}
    for name in windows:
        w = out[name]
        print(f"[profile] {name}: wall {w['wall_ms']:.2f} ms, device busy "
              f"{w['device_busy_ms']:.2f} ms ({100 * w['busy_share']:.1f}%),"
              f" {w['launches']} kernel launches, by name "
              f"{w['launches_named']}")
        for kname, ms in w["top_kernels_ms"]:
            print(f"[profile]   {ms:9.3f} ms  {kname}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
