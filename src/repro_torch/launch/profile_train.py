"""Where a training step's time goes on the card: its parts by CUDA events
and one whole step under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch qwen3-0.6b] [--batch 8] [--seq 512]

Builds chip_smoke.py's phase-6a run (full width, bf16 params from seed 0,
f32 moments, ``SyntheticLM`` seed 0, the plain path) and takes two warm-up
steps.  Then it times one step's three parts between CUDA events: the
loss forward (``registry.loss_fn``), its backward (each layer recomputed
under activation checkpointing), and the AdamW update; and it profiles one
whole ``train_step`` for its wall time, device busy time (the union of
its kernels' intervals), busy share, launches and the kernels that take the most device time
(``profile_serve._window``).  It prints them and one JSON line.  It needs a
card and fails without one.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.profile_serve import _window
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.train_step import init_train_state, train_step

SEED = 0
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ALL_ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    state = init_train_state(gen, cfg)
    batches = SyntheticLM(cfg, DataConfig(args.batch, args.seq, SEED),
                          device).batches()
    for _ in range(2):                # warm-up
        train_step(state, next(batches), cfg=cfg, opt_cfg=OPT)

    # the parts of one step, as train_step runs them, between CUDA events
    batch = next(batches)
    params = state["params"]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize(device)
    events[0].record()
    loss, _ = registry.loss_fn(params, cfg, batch)
    events[1].record()
    loss.backward()
    events[2].record()
    adamw_update(params, tree_map(lambda p: p.grad, params), state["opt"],
                 OPT)
    events[3].record()
    torch.cuda.synchronize(device)
    for p in tree_leaves(params):
        p.grad = None
    parts = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("forward_ms", "backward_ms",
                                       "update_ms"))}

    batch = next(batches)
    step = _window(lambda: train_step(state, batch, cfg=cfg, opt_cfg=OPT),
                   device)
    out = {"card": torch.cuda.get_device_name(device),
           "config": {"arch": cfg.name, "batch": args.batch,
                      "seq": args.seq},
           "parts": parts, "step": step}
    print(f"[profile] parts of one step (CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(f"[profile] step: wall {step['wall_ms']:.2f} ms, device busy "
          f"{step['device_busy_ms']:.2f} ms "
          f"({100 * step['busy_share']:.1f}%), {step['launches']} kernel "
          f"launches, by name {step['launches_named']}")
    for kname, ms in step["top_kernels_ms"]:
        print(f"[profile]   {ms:9.3f} ms  {kname}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
