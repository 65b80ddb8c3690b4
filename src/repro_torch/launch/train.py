"""Training driver, the reference's ``repro/launch/train.py`` on PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        [--smoke] --steps 100 --batch 8 --seq 128 [--ckpt /tmp/run] \
        [--device cuda]

Runs on the card (``--device cuda``, the default) and raises if there is
none; ``--device cpu`` trains on the CPU (with ``--smoke``, the reduced
same-family config, for a quick run).  On the card the step (forward,
backward, AdamW) is captured once as a CUDA graph and replayed, as the
reference jits it; on the CPU it runs op by op
(``training/train_graph.py``).  It trains on the plain path: the kernels
have no backward.  Checkpoints are in the reference's format, so
``--resume`` takes one written by either package; the step is captured
after the resume, on the loaded state.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_graph import TrainGraph, trainer_for
from repro_torch.training.train_step import init_train_state


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None, help="checkpoint path prefix")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] {cfg.name} ({'smoke' if args.smoke else 'FULL'}): "
          f"{cfg.n_layers}L d={cfg.d_model} family={cfg.family} on {device}")

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = init_train_state(gen, cfg)
    if args.resume:
        state = load_checkpoint(args.resume, state)
        print(f"[train] resumed from {args.resume}")
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps)
    data = SyntheticLM(cfg, DataConfig(batch=args.batch, seq=args.seq,
                                       seed=args.seed), device)
    trainer = trainer_for(state, cfg, opt, data.shapes(), args.microbatches,
                          device)
    if isinstance(trainer, TrainGraph):
        print(f"[train] step captured as one CUDA graph in "
              f"{trainer.capture_s:.2f} s")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    tokens_done = 0
    for i, batch in zip(range(args.steps), data.batches()):
        metrics = trainer.step(batch)
        tokens_done += args.batch * args.seq
        if i % args.log_every == 0 or i == args.steps - 1:
            sync()
            dt = time.perf_counter() - t0
            print(f"step {i:5d}  loss {float(metrics['loss']):9.4f}  "
                  f"aux {float(metrics['aux_loss']):7.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):7.2f}  "
                  f"{tokens_done / max(dt, 1e-9):9.0f} tok/s")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            path = f"{args.ckpt}.step{i + 1}.npz"
            save_checkpoint(path, state, step=i + 1)
            print(f"[train] checkpoint -> {path}")
    if args.ckpt:
        save_checkpoint(f"{args.ckpt}.final.npz", state, step=args.steps)
        print(f"[train] final checkpoint -> {args.ckpt}.final.npz")


if __name__ == "__main__":
    main()
