#!/usr/bin/env python3
"""Proof on the card that the PyTorch/CUDA port (src/repro_torch) runs.

    python3 chip_smoke.py        # from the root of a checkout, one NVIDIA GPU

Phases, each raising on failure (the script then exits non-zero):

1. card: name and power limit from nvidia-smi;
2. build: every kernel source under src/repro_torch/kernels/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and a few edge cases, with times;
4. serving: qwen3-0.6b at full width (random bf16 weights from a seed)
   through ServeEngine.run with the prefill on the flash kernel, counting
   the kernel's launches in that run;
5. early restart: the regrow loop of repro_torch.launch.serve on a slice
   smaller than the weights.

It prints a JSON line of kernel results, the card line, and last
``{"ok": true, "device": {...}}``.  Without a card it fails at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-0.6b"
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# tolerances of the reference's own kernel tests (tests/test_kernels.py:37,52)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# prefill logits, flash kernel vs plain attention, both on bf16 weights and
# activations: the plain path rounds scores and probabilities to bf16, the
# kernel keeps them in f32; 28 layers of bf16 residual stream carry that
# difference to the logits (relative to the largest logit)
PREFILL_REL_TOL = 5e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def timed_ms(torch, fn, n: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over n calls, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def attention_work(b, h, kh, s, d, itemsize, causal, window):
    """Bytes (q, k, v read once, o written once) and FLOPs (2 products of
    2*D per visible query-key pair) of one attention call."""
    pairs = 0
    for qpos in range(s):
        lo = 0 if window is None else max(0, qpos - window + 1)
        hi = qpos + 1 if causal else s
        pairs += hi - lo
    nbytes = itemsize * d * s * b * (2 * h + 2 * kh)
    return nbytes, 4 * d * pairs * b * h


def phase_kernels(torch, fa, flash_mha, attention_ref) -> dict:
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # (name, B, S, H, KH, D, dtype, causal, window); the first two are the
    # serving prefill's shape (qwen3-0.6b: 16 heads, 8 KV heads, D=128)
    cases = [
        ("prefill-bf16", 8, 512, 16, 8, 128, torch.bfloat16, True, None),
        ("prefill-f32", 8, 512, 16, 8, 128, torch.float32, True, None),
        ("ragged-s200", 8, 200, 16, 8, 128, torch.bfloat16, True, None),
        ("window128", 8, 512, 16, 8, 128, torch.bfloat16, True, 128),
        ("non-causal-s200", 2, 200, 16, 8, 128, torch.float32, False, None),
        ("gqa-8to1", 8, 512, 16, 2, 128, torch.bfloat16, True, None),
    ]
    errors = {}
    for name, b, s, h, kh, d, dtype, causal, window in cases:
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                   .to(dtype) for n in (h, kh, kh))
        out = flash_mha(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window
                            ).transpose(1, 2)
        err = (out.float() - ref.float()).abs()
        tol = TOL[str(dtype).split(".")[1]]
        bad = err > tol + tol * ref.float().abs()
        errors[name] = float(err.max())
        print(f"[kernels] flash_attention {name}: max_abs_err "
              f"{errors[name]:.3e} (tol {tol})", flush=True)
        if bool(bad.any()) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash_attention {name}: kernel disagrees "
                                 f"with attention_ref (max err "
                                 f"{errors[name]})")

    # times at the serving prefill's shape, in the kernel layout
    b, s, h, kh, d = 8, 512, 16, 8, 128
    q, k, v = (torch.randn((b, n, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for n in (h, kh, kh))
    kernel_ms = timed_ms(torch, lambda: fa.flash_attention(q, k, v))
    plain_ms = timed_ms(torch, lambda: attention_ref(q, k, v))
    library_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    nbytes, flops = attention_work(b, h, kh, s, d, 2, True, None)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    print(f"[kernels] flash_attention B={b} S={s} H={h} KH={kh} D={d} bf16 "
          f"causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({nbytes} B, {flops} FLOP)", flush=True)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "max_abs_err": errors["prefill-bf16"],
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "max_err": errors["prefill-bf16"], "kernel_ms": kernel_ms,
        "case_max_abs_err": errors,
    }


def phase_serving(torch, fa, cfg, params) -> dict:
    from repro_torch.core.mig_h100 import MigH100Backend
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import registry, transformer
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    n_req, prompt_len, max_new, context = 8, 512, 64, 1024
    reqs = make_requests(cfg, n_req, prompt_len, max_new, SEED)
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(
        "cuda", torch.int64)

    # prefill through the flash kernel against the plain attention path
    last = {}
    with torch.inference_mode():
        for impl in ("pallas", "xla"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            caches = registry.init_caches(c, n_req, context, "cuda")
            last[impl], _ = transformer.prefill(params, c, tokens, caches)
        caches = registry.init_caches(cfg, n_req, context, "cuda")
        prefill_ms = timed_ms(torch, lambda: transformer.prefill(
            params, cfg, tokens, caches), n=5, warmup=1)
    ref = last["xla"].float()
    rel = float((last["pallas"].float() - ref).abs().max()
                / ref.abs().max())
    print(f"[serving] prefill last logits, flash vs plain: rel err "
          f"{rel:.3e} (tol {PREFILL_REL_TOL})", flush=True)
    if not (rel < PREFILL_REL_TOL
            and bool(torch.isfinite(last["pallas"]).all())):
        raise AssertionError(f"prefill logits disagree: rel err {rel}")

    # the main path, with the kernel's launch count read around it
    engine = ServeEngine(cfg, params,
                         EngineConfig(max_batch=n_req, max_context=context,
                                      predict=False),
                         backend=MigH100Backend(), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fa.launches
    print(f"[serving] flash_attention launches in ServeEngine.run: "
          f"{launches} (layers {cfg.n_layers})", flush=True)
    if launches != cfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernel {launches} "
                             f"times, want {cfg.n_layers}")
    n_tok = sum(len(r.generated) for r in out)
    if n_tok != n_req * max_new or not all(
            0 <= t < cfg.vocab for r in out for t in r.generated):
        raise AssertionError(f"bad generations: {n_tok} tokens")
    if len(engine.accountant.history) != 1 + max_new:
        raise AssertionError("accountant missed iterations")
    stats = {
        "arch": cfg.name, "requests": n_req, "prompt_len": prompt_len,
        "new_tokens": max_new, "max_context": context,
        "prefill_ms": prefill_ms, "run_s": run_s,
        "decode_ms_per_step": (run_s * 1e3 - prefill_ms) / max_new,
        "tokens_per_s": n_tok / run_s,
        "accountant_peak_in_use_gb": engine.accountant.peak_in_use / 2**30,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
        "flash_launches": launches,
        "prefill_flash_vs_plain_rel_err": rel,
    }
    print(f"[serving] {json.dumps(stats)}", flush=True)
    print(f"[serving] req 0: {out[0].generated[:16]}", flush=True)
    return stats


def phase_smoke_tokens(torch) -> None:
    """Greedy tokens of the 2-layer smoke config with f32 weights: the
    flash kernel path and the plain path must pick the same tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import registry
    from repro_torch.models.module import cast_tree
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = get_smoke_config(ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = cast_tree(registry.init_params(gen, cfg)[0], torch.float32)
    got = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        reqs = make_requests(c, 4, 100, 24, SEED)
        eng = ServeEngine(c, params, EngineConfig(max_batch=4,
                                                  max_context=256,
                                                  predict=False),
                          device="cuda")
        got[impl] = [r.generated for r in eng.run(reqs)]
    if got["pallas"] != got["xla"]:
        raise AssertionError("smoke config: flash and plain paths "
                             "generated different tokens")
    print(f"[smoke] f32 smoke config: identical greedy tokens on both "
          f"attention paths ({sum(map(len, got['xla']))} tokens)",
          flush=True)


def phase_restart(cfg, params) -> list[str]:
    from repro_torch.core.mig_h100 import MigH100Backend
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models.module import param_bytes

    backend = MigH100Backend()
    partition_gb = 1.0
    weights_gb = param_bytes(params) / 2**30
    if partition_gb >= weights_gb:
        raise AssertionError(f"partition {partition_gb} GB must be below the "
                             f"weights' {weights_gb:.3f} GB")
    reqs = make_requests(cfg, 2, 64, 16, SEED)
    engine, out, restarts = serve(cfg, params, reqs, max_context=256,
                                  partition_gb=partition_gb,
                                  backend=backend, device="cuda")
    names = {p.name for p in backend.profiles}
    if not restarts or not any(n in restarts[0] for n in names):
        raise AssertionError(f"no early restart to an H100 profile: "
                             f"{restarts}")
    if not all(len(r.generated) == 16 for r in out):
        raise AssertionError("the regrown run did not finish")
    print(f"[restart] weights {weights_gb:.3f} GB on a {partition_gb} GB "
          f"slice; finished on {engine.ecfg.partition_gb} GB after "
          f"{len(restarts)} restart(s)", flush=True)
    return restarts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import registry

    # plain versions in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # 2. build every kernel source, all nvcc processes at once
    t0 = time.perf_counter()
    built = build.build()
    print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for res in built.values():
        for line in res.log.splitlines():
            if "registers" in line:
                print(f"[build] {res.name}: {line.strip()}", flush=True)

    # 3. each kernel against its plain version
    kernel = phase_kernels(torch, fa, flash_mha, attention_ref)

    # 4. full-width serving on the flash prefill
    phase_smoke_tokens(torch)
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="pallas")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params, _ = registry.init_params(gen, cfg)
    serving = phase_serving(torch, fa, cfg, params)
    kernel["launches"] = serving["flash_launches"]

    # 5. early restart and regrow (serve prints each restart line)
    phase_restart(cfg, params)

    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
