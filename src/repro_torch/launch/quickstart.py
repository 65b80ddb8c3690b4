"""Quickstart: train a small qwen3-family model for a few hundred steps and
watch the loss drop, then save/restore a checkpoint and serve a few greedy
completions from the trained weights; the port's copy of the reference's
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--steps 200] \
        [--batch 8] [--seq 128] [--device cpu]

Runs on the card unless given ``--device cpu``, as ``launch/train.py``
does, with the train step captured as one CUDA graph there and run op by
op on the CPU (``training/train_graph.py``).  The model is the reduced
``qwen3-0.6b`` smoke config at its default ``attn_impl``, as in the
reference, so neither training nor serving reaches a hand-written
kernel.  The checkpoint goes through
``training/checkpoint.py`` into a temporary directory and must come back
bit for bit.  :func:`main` returns what it printed: the logged losses,
the checkpoint's leaf count and the generated tokens.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.training.checkpoint import (flatten, load_checkpoint,
                                             same_bits, save_checkpoint)
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_graph import trainer_for
from repro_torch.training.train_step import init_train_state

ARCH = "qwen3-0.6b"
#: steps between logged losses (the reference's cadence)
LOG_EVERY = 20


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.quickstart")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(ARCH)
    print(f"arch: {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model}) "
          f"on {device}")

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_train_state(gen, cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    data = SyntheticLM(cfg, DataConfig(batch=args.batch, seq=args.seq),
                       device)
    trainer = trainer_for(state, cfg, opt, data.shapes(), 1, device)

    losses: dict[int, float] = {}
    for i, batch in zip(range(args.steps), data.batches()):
        metrics = trainer.step(batch)
        if i % LOG_EVERY == 0 or i == args.steps - 1:
            losses[i] = float(metrics["loss"])
            print(f"step {i:4d}  loss {losses[i]:8.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}")

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/ckpt.npz"
        save_checkpoint(path, state, step=args.steps)
        restored = load_checkpoint(path, state)
        want, got = flatten(state), flatten(restored)
        if sorted(want) != sorted(got) or not all(
                same_bits(want[k], got[k]) for k in want):
            raise AssertionError("checkpoint round trip is not bitwise")
        leaf = next(iter(flatten(restored["params"]).values()))
        print(f"checkpoint round-trip OK ({len(want)} leaves bit for bit, "
              f"{leaf.dtype}, step {args.steps})")
    del restored, got

    engine = ServeEngine(cfg, state["params"],
                         EngineConfig(max_batch=2, max_context=64,
                                      predict=False), device=device)
    reqs = [Request(uid=i, prompt=np.arange(4, dtype=np.int32) + i,
                    max_new_tokens=12) for i in range(2)]
    generated = []
    for r in engine.run(reqs):
        print(f"request {r.uid}: generated {r.generated}")
        generated.append(list(r.generated))
    return {"losses": losses, "checkpoint_leaves": len(want),
            "generated": generated}


if __name__ == "__main__":
    main()
