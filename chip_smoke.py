#!/usr/bin/env python3
"""Proof on the card that the PyTorch/CUDA port (src/repro_torch) runs.

    python3 chip_smoke.py        # from the root of a checkout, one NVIDIA GPU

Phases, each raising on failure (the script then exits non-zero):

1. card: name and power limit from nvidia-smi;
2. build: every kernel source under src/repro_torch/kernels/csrc with nvcc
   (flash_attention.cu, flash_attention_sm90.cu, ssd_scan.cu and
   ssd_scan_sm90.cu, one nvcc each, started together), printing nvcc's
   and ptxas's whole output;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving paths' shapes (flash at qwen3's, zamba2's, whisper's,
   gemma-2b's (D=256, MQA), gemma3-27b's local (window 1024 over 1536
   positions) and global layers', pixtral's, grok-1's (GQA 6:1) and
   llama4-maverick's global layers' (GQA 5:1); SSD at mamba2's and
   zamba2's) and a few edge cases, with times at each serving shape; the
   flash cases go to both routes (bf16 at D 64/112/128/256 to the wgmma
   kernel "sm90", f32 to the CUDA-core kernel "simt"), and so do the
   SSD cases (bf16 at P=64, N 64 or 128 and a chunk that is a multiple of
   64 to the wgmma kernel "sm90", the rest to the CUDA-core kernel
   "simt"), each case's launch counted on the route it must take;
4. serving: qwen3-0.6b at full width (random bf16 weights from a seed)
   through ServeEngine.run with the prefill on the flash kernel, counting
   the kernels' launches in that run (28 on "sm90", none on "simt");
5. early restart: the regrow loop of repro_torch.launch.serve on a slice
   smaller than the weights;
5b. multi-tenant: repro_torch.launch.multi_tenant's flow on phase 4's
   weights: three tenants lease 1g.10gb slices of the H100 MIG FSM through
   the partition manager (GPC 3, 1 and 5, reachability 148 -> 76 -> 37 ->
   17), each run capped at its lease by the allocator's memory fraction
   (MIG instances are not created); tenant-a and tenant-b decode 24 tokens
   at batch 1 in a context of 256, tenant-c-growing 128 tokens at batch 8
   in a context of 4096, until its predictor flags the lease and it
   restarts early on 1g.20gb; per tenant the profile and GPC, decode
   ms/step and the allocator's peak beside the lease, for the growing one
   the restart step and predicted peak; no kernel launches, the card's
   FSM empty at the end;
4b. serving: mamba2-2.7b at full width through ServeEngine.run with the
   prefill's SSD on the chunk-scan kernel, counting the launches (64 on
   "sm90", none on "simt"), after qwen3's weights are freed; then the f32
   smoke config's greedy tokens on both SSD paths;
4c. serving: zamba2-7b at full width and depth (81 Mamba2 layers, the
   shared attention block applied 13 times) through ServeEngine.run with
   the prefill on both kernels, counting the launches (13 flash and 81 SSD,
   all on "sm90"), after mamba2's weights are freed: every block (Mamba2
   mixer and shared attention) kernel vs plain, one by one, on f32 weights
   (both "simt" kernels) and on bf16 weights (both "sm90" kernels), and
   the f32 last logits printed beside; then the f32 smoke config's greedy
   tokens on both paths;
4d. serving: whisper-medium (24 encoder and 24 decoder layers) at full
   width through ServeEngine.run, 8 prompts of 224 tokens in a context of
   448, the encoder first over zero frames (plain, as in the reference),
   then the decoder's prefill with its self attention on the flash kernel,
   counting the launches (24 flash, all on "sm90"; no SSD), after zamba2's
   weights are freed: the f32 prefill's last logits on the "simt" kernel
   vs plain on the weights with wq and wk scaled by 0.1 (the random init
   is chaotic, see check_whisper_prefill), each decoder layer's f32 self
   attention ("simt") and bf16 self attention ("sm90") against its plain
   version one by one; encoder ms and prefill ms by CUDA events; then the
   f32 smoke config's greedy tokens on both paths;
4e. serving: the remaining dense and VLM configs, each at full width and
   depth on freed memory through ServeEngine.run, the prefill on the flash
   kernel: qwen3-1.7b (28 launches), gemma-2b (18, head dim 256 with one
   KV head), gemma3-27b (62, 52 of them with the window of 1024; 8 prompts
   of 1536 tokens in a context of 2048) and pixtral-12b (40, served on text
   tokens as the reference's engine serves it), all on "sm90", none on
   "simt", no SSD: each layer's bf16 self attention against its plain
   version one by one, the last logits flash vs plain (held for the
   qk-norm models; for gemma-2b and pixtral, whose random init is chaotic,
   held on the weights with wq and wk rescaled to the fan-in d_model and
   printed as drawn, see check_dense_prefill; pixtral's also with 256 stub
   patches), the init's own peak memory, then the f32 smoke config's
   greedy tokens on both paths;
4g. cache variants, on 4e's gemma3-27b weights and traffic before they
   are freed: the windowed ring cache (52 local layers keep rings of 1024
   slots) and the int8 cache.  The plain prefill and 8 decode steps
   teacher-forced on the plain run's tokens, then each variant's prefill
   (62 sm90 flash launches, 52 windowed): every ring slot p mod 1024 and
   every global cache equal to the plain cache bit for bit; the int8
   quantizer within half a scale step of what it quantized, layer 0 within
   one step of the plain cache; each variant's teacher-forced logits held
   to plain decode's (windowed at 5e-2, int8 at 0.02); then ServeEngine.run
   with each variant and with the plain cache again (62 / 52 launches
   each), and decode ms/step and the serving peaks (accountant and
   allocator) of plain, windowed, int8 and plain again;
4f. serving: the MoE configs at their published widths and expert counts,
   cut in depth to fit the card (configs.ONE_CARD_LAYERS), each on freed
   memory through ServeEngine.run: grok-1-314b, 6 of 64 layers (6 flash
   launches, GQA 6:1), and llama4-maverick-400b-a17b, 4 of 48 (2 dense, 2
   MoE of 128 experts; 1 flash launch on its global layer, GQA 5:1, the 3
   chunked layers plain), all on "sm90", none on "simt", no SSD: each
   flash layer's bf16 self attention against its plain version, each MoE
   layer's moe_tokens (the engine's expert-by-expert dispatch and combine)
   against moe_layer at S=1 and its routes on the card against the CPU's
   on the same bf16 inputs, the last logits flash vs plain with the tokens
   whose routes flip counted (see check_moe_prefill), the init's own peak
   memory, then the f32 smoke config's greedy tokens on both paths;
6. training, on the plain path (the kernels have no backward and refuse
   autograd): (a) qwen3-0.6b at full width, bf16 params and f32 moments,
   8 steps of B=8, S=512 through make_train_step as launch/train.py runs
   them, with each step's loss, grad norm and ms, tokens/s and peak
   memory; the kernels' launch counts must not move; the final state
   saved and loaded through training/checkpoint.py must come back bit for
   bit; (b) the three smoke configs in f32, 3 steps on the card against
   the same steps on the CPU, loss and grad norm within 1e-4; (c) both
   kernels, on both routes, raise when an input requires grad;
7. scheduler: the paper's batch scheduler through the port's entry points
   on the card machine's host (the scheduler models the device and
   launches nothing on it; the kernels' counts must stay 0): (a) Fig. 4,
   all 14 workloads (Hm1-Hm4, Ht1-Ht3, Ml1-Ml3, qwen2, llama3,
   flan_t5_train, flan_t5) at the paper's job counts, every arm
   (baseline, Scheme A, Scheme B, A with work stealing on the Ml mixes,
   A with and without the predictor on the LLM workloads), on the A100's
   MIG geometry with A100_POWER and the H100's with H100_POWER, each
   makespan and energy against a pinned table at rel 1e-9 and each OOM,
   early-restart and reconfiguration count exactly; (b) a traced Hm3
   Scheme B run streamed to JSONL by the flight recorder, its Metrics
   equal to the untraced run's, its Chrome trace written, replayed and
   graded by the regret oracle against pinned values; (c) the regret
   gate on Hm3, Hm4 and Ht1: no arm beats the oracle, Scheme B's regret
   is no more than the baseline's; then H100_POWER's peak beside the
   card's power limit.  Every makespan, energy and ratio here is the
   simulator's output, not a measurement of the card; only the phase's
   host seconds are the machine's;
8. serving simulator and fleet: launch/serving_sim.py (the reference's
   benchmarks/bench_serving.py: 8 arms, A100 and H100 x full / static /
   dynamic / dynamic+pred, 300 Poisson requests at 2.0/s) and
   launch/fleet_sim.py (bench_fleet.py: 3 fleet shapes x 4 routers), each
   with its checks, on the host; no kernel launch; every figure is the
   simulator's, only the seconds are the machine's.

Each phase prints its host seconds as it ends.  The script prints a JSON
line of kernel results, the card line, and last ``{"ok": true, "device":
{...}}``.  Without a card it fails at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-0.6b"
SSM_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "zamba2-7b"
AUDIO_ARCH = "whisper-medium"
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12           # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# tolerances of the reference's own kernel tests (tests/test_kernels.py:37,52)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# ... and of its SSD tests (tests/test_kernels.py:99,123); the final state
# is f32 whatever x's dtype, so it is held to the f32 tolerance
SSD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
SSD_STATE_TOL = 2e-4
# qwen3 prefill logits, flash kernel vs plain attention, both on bf16
# weights and activations: the plain path rounds scores and probabilities
# to bf16, the kernel keeps them in f32; 28 layers of bf16 residual stream
# carry that difference to the logits (relative to the largest logit)
PREFILL_REL_TOL = 5e-2
# mamba2 prefill logits on the same random weights cast to f32, SSD kernel
# vs plain chunked SSD: both sum in f32 in other orders (~1e-6 a layer),
# and 64 layers amplify that (relative to the largest logit); zamba2's f32
# blocks are held to it one by one (see check_hybrid_prefill)
SSM_PREFILL_F32_REL_TOL = 1e-3
# mamba2 on its bf16 weights, layer by layer: each layer's mixer output on
# the kernel against the plain chunked SSD, both fed the plain path's
# residual stream (relative to the layer's largest output).  The last
# logits are not compared in bf16: over 64 random layers two plain paths
# that differ only in the chunk already disagree by ~0.1 of the largest
# logit.  zamba2's 81 random bf16 layers are held the same way, each Mamba2
# mixer and each shared-attention output.
SSM_LAYER_REL_TOL = 5e-2


class PhaseClock:
    """Host seconds of each phase, printed as the phase ends."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.seconds[name] = time.perf_counter() - t0
        print(f"[time] phase {name}: {self.seconds[name]:.1f} s", flush=True)


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


def graph_ms(torch, fn, n: int = 20, reps: int = 5) -> float:
    """Mean device time of fn: n calls captured in a CUDA graph, replayed
    reps times between CUDA events.  Used where one call's host side (the
    wrapper's checks, tensor maps and launch) takes longer than its kernel,
    so back-to-back eager calls would time the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (n * reps)


def flash_route(torch, dtype, d) -> str:
    """The kernel the wrapper must pick: the wgmma kernel for bf16 at head
    dims 64, 112, 128 and 256, the CUDA-core kernel for everything else."""
    return ("sm90" if dtype == torch.bfloat16 and d in (64, 112, 128, 256)
            else "simt")


#: the serving prefills' attention shapes (B, S, H, KH, D, window), causal,
#: the archs whose prefill calls the kernel at that shape, and the prefix
#: of their cases' names: qwen3-0.6b and qwen3-1.7b (GQA 2:1, D=128; one
#: shape, the same 16 heads of 128 at both widths), zamba2-7b (MHA at
#: D=112: the wgmma kernel's one-head-two-q-tiles layout), whisper-medium's
#: decoder (MHA at D=64; its 224 prompt positions padded to 256 by
#: ops.flash_mha, the kernel hiding keys from 224 on), gemma-2b (MQA at
#: D=256: the kernel's one-block-an-SM code), gemma3-27b's 52 local layers
#: (a window of 1024 over 1536 prompt tokens) and its 10 global layers,
#: pixtral-12b (GQA 4:1, D=128), grok-1-314b (GQA 6:1, two heads a block)
#: and llama4-maverick's global layers (GQA 5:1, the first odd group above
#: 1: one head over two q tiles a block, K/V head h // 5)
FLASH_SERVING = [
    (("qwen3-0.6b", "qwen3-1.7b"), "prefill", (8, 512, 16, 8, 128, None)),
    (("zamba2-7b",), "zamba2", (8, 512, 32, 32, 112, None)),
    (("whisper-medium",), "whisper", (8, 224, 16, 16, 64, None)),
    (("gemma-2b",), "gemma2b", (8, 512, 8, 1, 256, None)),
    (("gemma3-27b",), "gemma3-local", (8, 1536, 32, 16, 128, 1024)),
    (("gemma3-27b",), "gemma3-global", (8, 1536, 32, 16, 128, None)),
    (("pixtral-12b",), "pixtral", (8, 512, 32, 8, 128, None)),
    (("grok-1-314b",), "grok", (8, 512, 48, 8, 128, None)),
    (("llama4-maverick-400b-a17b",), "llama4-global",
     (8, 512, 40, 8, 128, None))]


def phase_kernels(torch, fa, flash_mha, attention_ref) -> list[dict]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # (name, B, S, H, KH, D, dtype, causal, window): each serving prefill's
    # shape in bf16 and f32, then edge cases.  bf16 cases at D 64, 112, 128
    # and 256 go to the wgmma kernel, the rest to the CUDA-core kernel.
    cases = [(f"{tag}-{name}", *shape[:5], dtype, True, shape[5])
             for _, tag, shape in FLASH_SERVING
             for name, dtype in (("bf16", torch.bfloat16),
                                 ("f32", torch.float32))]
    cases += [
        ("ragged-s200", 8, 200, 16, 8, 128, torch.bfloat16, True, None),
        ("window128", 8, 512, 16, 8, 128, torch.bfloat16, True, 128),
        ("non-causal-s200", 2, 200, 16, 8, 128, torch.float32, False, None),
        ("gqa-8to1", 8, 512, 16, 2, 128, torch.bfloat16, True, None),
        ("mha-d64-s1024", 2, 1024, 8, 8, 64, torch.bfloat16, True, None),
        ("non-causal-s200-bf16", 2, 200, 16, 8, 128, torch.bfloat16, False,
         None),
        ("zamba2-ragged-s200", 8, 200, 32, 32, 112, torch.bfloat16, True,
         None),
        # D=256 on the wgmma kernel: ragged S, a window, an odd group (one
        # head over two q tiles a block), S=1024, non-causal ragged
        ("gemma2b-ragged-s200", 8, 200, 8, 1, 256, torch.bfloat16, True,
         None),
        ("gemma2b-window128", 8, 512, 8, 1, 256, torch.bfloat16, True, 128),
        ("d256-mqa-odd-h3", 8, 512, 3, 1, 256, torch.bfloat16, True, None),
        ("d256-mqa-s1024", 2, 1024, 8, 1, 256, torch.bfloat16, True, None),
        ("d256-non-causal-s200", 2, 200, 8, 2, 256, torch.bfloat16, False,
         None),
        # the MoE configs' GQA groups of 6 and 5 at a ragged S
        ("grok-ragged-s200", 8, 200, 48, 8, 128, torch.bfloat16, True, None),
        ("llama4-global-ragged-s200", 8, 200, 40, 8, 128, torch.bfloat16,
         True, None),
    ]
    errors, routes = {}, {}
    for name, b, s, h, kh, d, dtype, causal, window in cases:
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                   .to(dtype) for n in (h, kh, kh))
        before = dict(fa.launches_by_route)
        out = flash_mha(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        route = routes[name] = flash_route(torch, dtype, d)
        moved = {r: fa.launches_by_route[r] - before[r] for r in before}
        if moved != {r: int(r == route) for r in fa.ROUTES}:
            raise AssertionError(f"flash_attention {name}: launches by "
                                 f"route {moved}, want one on {route}")
        ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window
                            ).transpose(1, 2)
        err = (out.float() - ref.float()).abs()
        tol = TOL[str(dtype).split(".")[1]]
        bad = err > tol + tol * ref.float().abs()
        errors[name] = float(err.max())
        print(f"[kernels] flash_attention {name} ({route}): max_abs_err "
              f"{errors[name]:.3e} (tol {tol})", flush=True)
        if bool(bad.any()) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash_attention {name}: kernel disagrees "
                                 f"with attention_ref (max err "
                                 f"{errors[name]})")
    return [entry for archs, tag, shape in FLASH_SERVING
            for entry in flash_timings(torch, fa, attention_ref, gen, archs,
                                       tag, shape, errors, routes)]


def flash_timings(torch, fa, attention_ref, gen, archs, tag, shape, errors,
                  routes) -> list[dict]:
    """Device times at a serving prefill's shape, all in this call: the
    wgmma kernel on model-layout views (as the prefill hands them over),
    the CUDA-core kernel in f32 (its route) and in bf16 (the kernel the
    bf16 prefill would run without the wgmma kernel, timed as a
    yardstick), the plain versions, and scaled_dot_product_attention (not
    used by the port); returns the kernels line's entry of each route.  A
    prompt length that is no block multiple is zero-padded as
    ops.flash_mha pads it, and every call gets the padded inputs: the
    kernels and the plain version hide the keys past the prompt
    (``kv_len``), SDPA's causal mask hides them from the prompt's rows.
    With a window SDPA takes the causal window as a boolean mask.  The
    bound counts the prompt's own work."""
    import torch.nn.functional as F
    b, s, h, kh, d, window = shape
    arch = archs[0]
    s_pad = -(-s // fa.BLOCK) * fa.BLOCK
    kv_len = s if s_pad != s else None
    sdpa_args = {"is_causal": True}
    if window is not None:
        pos = torch.arange(s_pad, device="cuda")
        sdpa_args = {"attn_mask": (pos[None] <= pos[:, None])
                     & (pos[:, None] - pos[None] < window)}
    qm, km, vm = (F.pad(torch.randn((b, s, n, d), generator=gen,
                                    device="cuda"), (0, 0, 0, 0, 0, s_pad - s))
                  .to(torch.bfloat16) for n in (h, kh, kh))
    q, k, v = (x.transpose(1, 2) for x in (qm, km, vm))
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    q32, k32, v32 = (x.float() for x in (qc, kc, vc))
    ms = {
        "sm90": graph_ms(torch, lambda: fa.flash_attention(
            q, k, v, window=window, kv_len=kv_len)),
        "simt_f32": graph_ms(torch, lambda: fa.flash_attention(
            q32, k32, v32, window=window, kv_len=kv_len)),
        "simt_bf16": graph_ms(torch, lambda: fa._launch(
            "simt", qc, kc, vc, causal=True, window=window, kv_len=s)),
        "plain_bf16": graph_ms(torch, lambda: attention_ref(
            qc, kc, vc, window=window, kv_len=kv_len)),
        "plain_f32": graph_ms(torch, lambda: attention_ref(
            q32, k32, v32, window=window, kv_len=kv_len)),
        "sdpa_bf16": graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qc, kc, vc, enable_gqa=True, **sdpa_args)),
        "sdpa_f32": graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q32, k32, v32, enable_gqa=True, **sdpa_args)),
        "sm90_again": graph_ms(torch, lambda: fa.flash_attention(
            q, k, v, window=window, kv_len=kv_len)),
    }
    entries = []
    for route, dtype, peak in (("sm90", "bfloat16", PEAK_BF16_FLOPS),
                               ("simt", "float32", PEAK_F32_FLOPS)):
        itemsize = 2 if dtype == "bfloat16" else 4
        nbytes, flops = attention_work(b, h, kh, s, d, itemsize, True,
                                       window)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        key = "bf16" if dtype == "bfloat16" else "f32"
        kernel_ms = ms["sm90" if route == "sm90" else "simt_f32"]
        padded = f" (padded to {s_pad})" if s_pad != s else ""
        windowed = f" window {window}" if window else ""
        print(f"[kernels] flash_attention ({route}) {tag} B={b} S={s}"
              f"{padded} H={h} KH={kh} D={d} {key} causal{windowed}: kernel "
              f"{kernel_ms:.4f} ms, plain {ms['plain_' + key]:.4f} ms, sdpa "
              f"{ms['sdpa_' + key]:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B, {flops} FLOP)",
              flush=True)
        entries.append({
            "name": "flash_attention", "route": "cuda", "kernel_route": route,
            "arch": arch, "archs": list(archs), "shape": tag,
            "window": window, "dtype": dtype,
            "source": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
                       if route == "sm90" else
                       "src/repro_torch/kernels/csrc/flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention.py:25",
            "max_abs_err": errors[f"{tag}-{key}"],
            "ms": kernel_ms, "plain_ms": ms["plain_" + key],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": ms["sdpa_" + key],
            "case_max_abs_err": {n: e for n, e in errors.items()
                                 if routes[n] == route},
        })
    entries[0]["ms_repeat"] = ms["sm90_again"]
    entries[0]["simt_bf16_ms"] = ms["simt_bf16"]
    print(f"[kernels] flash_attention bf16 at {tag}'s shape: sm90 "
          f"{ms['sm90']:.4f} / {ms['sm90_again']:.4f} ms against the simt "
          f"kernel's {ms['simt_bf16']:.4f} ms on the same inputs", flush=True)
    return entries


def ssd_work(b, s, h, p, n, chunk, itemsize):
    """Bytes (x, dt, a, B, C read once; y and the final state written once)
    and the FLOPs the function needs: per (b, chunk) one causal C B^T (2 N
    per pair i <= j; B and C are shared by the heads), and per (b, h,
    chunk) scores @ dt x over the same pairs (2 P each), the state update
    (2 Q N P) and, after the first chunk, whose state is zero, C . state
    (2 Q N P)."""
    nbytes = (2 * itemsize * b * s * h * p
              + 4 * (b * s * h + h + 2 * b * s * n + b * h * p * n))
    flops = 0
    for start in range(0, s, chunk):
        q = min(chunk, s - start)
        pairs = q * (q + 1) // 2
        inter = 2 * q * n * p if start else 0
        flops += b * 2 * n * pairs + b * h * (2 * p * pairs
                                              + 2 * q * n * p + inter)
    return nbytes, flops


def ssd_errors(y, state, y_ref, state_ref, tol):
    """Max abs errors of y and the state, and whether either leaves its
    tolerance (atol = rtol) or is not finite."""
    err_y = (y.float() - y_ref.float()).abs()
    err_s = (state - state_ref).abs()
    bad = (bool((err_y > tol + tol * y_ref.float().abs()).any())
           or bool((err_s > SSD_STATE_TOL
                    + SSD_STATE_TOL * state_ref.abs()).any())
           or not bool(y.isfinite().all())
           or not bool(state.isfinite().all()))
    return float(err_y.max()), float(err_s.max()), bad


#: the serving prefills' SSD shapes (B, S, H, P, N, chunk) and the prefix
#: of their cases' names: mamba2-2.7b (N=128) and zamba2-7b (N=64, which
#: the sm90 route zero-pads to the kernel's 128)
SSD_SERVING = [("mamba2-2.7b", "prefill", (8, 512, 80, 64, 128, 256)),
               ("zamba2-7b", "zamba2", (8, 512, 112, 64, 64, 256))]


def phase_ssd_kernel(torch, ssd, ssd_mixer, ssd_ref, ssd_chunked
                     ) -> list[dict]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)

    def inputs(b, s, h, p, n, dtype):
        # the reference tests' SSD inputs (tests/test_kernels.py:81-90)
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (rnd(b, s, h, p) * 0.5).to(dtype)
        dt = torch.nn.functional.softplus(rnd(b, s, h))
        a = -torch.exp(rnd(h) * 0.2)
        return x, dt, a, rnd(b, s, n) * 0.3, rnd(b, s, n) * 0.3

    # (name, B, S, H, P, N, chunk, dtype, the route the call must take):
    # each serving prefill's shape in bf16 and f32, then edge cases
    cases = [(f"{tag}-{name}", *shape, dtype, route)
             for _, tag, shape in SSD_SERVING
             for name, dtype, route in (("bf16", torch.bfloat16, "sm90"),
                                        ("f32", torch.float32, "simt"))]
    cases += [
        ("ragged-s200", 8, 200, 80, 64, 128, 256, torch.float32, "simt"),
        ("chunk64-s512", 8, 512, 80, 64, 128, 64, torch.bfloat16, "sm90"),
        ("one-partial-chunk-s100", 8, 100, 80, 64, 128, 256, torch.float32,
         "simt"),
        ("h1", 8, 512, 1, 64, 128, 256, torch.bfloat16, "sm90"),
        ("ragged-s200-bf16", 8, 200, 80, 64, 128, 256, torch.bfloat16,
         "sm90"),
        ("bf16-p128-n16-chunk32", 8, 512, 8, 128, 16, 32, torch.bfloat16,
         "simt"),
        ("zamba2-chunk64", 8, 512, 112, 64, 64, 64, torch.bfloat16, "sm90"),
    ]
    errors, routes = {}, {}
    for name, b, s, h, p, n, chunk, dtype, route in cases:
        args = inputs(b, s, h, p, n, dtype)
        before = dict(ssd.launches_by_route)
        y, state = ssd_mixer(*args, chunk=chunk)
        torch.cuda.synchronize()
        routes[name] = route
        moved = {r: ssd.launches_by_route[r] - before[r] for r in before}
        if moved != {r: int(r == route) for r in ssd.ROUTES}:
            raise AssertionError(f"ssd_scan {name}: launches by route "
                                 f"{moved}, want one on {route}")
        y_ref, state_ref = ssd_ref(*args)
        if state.shape != (b, h, p, n):   # no padded state column returned
            raise AssertionError(f"ssd_scan {name}: state {state.shape}")
        tol = SSD_TOL[str(dtype).split(".")[1]]
        errors[name], err_s, bad = ssd_errors(y, state, y_ref, state_ref,
                                              tol)
        print(f"[kernels] ssd_scan {name} ({route}): y max_abs_err "
              f"{errors[name]:.3e} (tol {tol}), state max_abs_err "
              f"{err_s:.3e} (tol {SSD_STATE_TOL})", flush=True)
        if bad:
            raise AssertionError(f"ssd_scan {name}: kernel disagrees with "
                                 f"ssd_ref (y err {errors[name]}, state err "
                                 f"{err_s})")

    return [entry for arch, _, shape in SSD_SERVING
            for entry in ssd_timings(torch, ssd, ssd_ref, ssd_chunked, inputs,
                                     arch, shape, errors, routes)]


def ssd_timings(torch, ssd, ssd_ref, ssd_chunked, inputs, arch, shape,
                errors, routes) -> list[dict]:
    """Both kernels at a serving prefill's shape on the same bf16 inputs:
    each held to ssd_ref there, then timed twice, in turns (sm90, simt,
    simt, sm90), by CUDA-graph replay (the sm90 time includes the wrapper's
    padding of B and C where N is 64).  The plain version is a 512-step
    loop, so it is timed over fewer eager calls; the plain chunked SSD (the
    model's ssm_impl="xla" path) is timed beside it.  Returns the kernels
    line's entry of each route."""
    b, s, h, p, n, chunk = shape
    args = inputs(b, s, h, p, n, torch.bfloat16)
    y_ref, state_ref = ssd_ref(*args)
    serving_err = {}
    for route in ssd.ROUTES:
        y, state = ssd._launch(route, *args, chunk)
        torch.cuda.synchronize()
        serving_err[route], err_s, bad = ssd_errors(
            y, state, y_ref, state_ref, SSD_TOL["bfloat16"])
        if bad:
            raise AssertionError(f"ssd_scan ({route}) at {arch}'s shape: "
                                 f"y err {serving_err[route]}, state err "
                                 f"{err_s}")
    ms = {}
    for key in ("sm90", "simt", "simt_again", "sm90_again"):
        route = key.split("_")[0]
        ms[key] = graph_ms(torch, lambda: ssd._launch(route, *args, chunk))
    plain_ms = timed_ms(torch, lambda: ssd_ref(*args), n=3, warmup=1)
    chunked_ms = timed_ms(torch, lambda: ssd_chunked(*args, chunk), n=5,
                          warmup=1)
    nbytes, flops = ssd_work(b, s, h, p, n, chunk, 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    print(f"[kernels] ssd_scan {arch} B={b} S={s} H={h} P={p} N={n} "
          f"Q={chunk} x bf16: sm90 {ms['sm90']:.4f} / "
          f"{ms['sm90_again']:.4f} ms, simt "
          f"{ms['simt']:.4f} / {ms['simt_again']:.4f} ms, plain "
          f"{plain_ms:.4f} ms, plain chunked {chunked_ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B, {flops} FLOP); no "
          f"single PyTorch call computes it", flush=True)
    entries = []
    for route, source in (("sm90", "ssd_scan_sm90.cu"),
                          ("simt", "ssd_scan.cu")):
        entries.append({
            "name": "ssd_scan", "route": "cuda", "kernel_route": route,
            "arch": arch, "archs": [arch], "dtype": "bfloat16",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/ssd_scan.py:29",
            "max_abs_err": serving_err[route],
            "ms": ms[route], "ms_repeat": ms[route + "_again"],
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "plain_chunked_ms": chunked_ms,
            "case_max_abs_err": {k: e for k, e in errors.items()
                                 if routes[k] == route},
        })
    return entries


N_REQ, PROMPT_LEN, MAX_NEW, CONTEXT = 8, 512, 64, 1024


#: phase 4d's traffic: whisper's text context is 448 tokens, and its
#: long-form decoding conditions each window on up to 224 tokens of the
#: previous window's text (arXiv:2212.04356)
AUDIO_PROMPT_LEN, AUDIO_CONTEXT = 224, 448


def serving_requests(torch, cfg, prompt_len=PROMPT_LEN):
    """The serving phases' requests and their prompt batch on the card."""
    from repro_torch.launch.serve import make_requests
    reqs = make_requests(cfg, N_REQ, prompt_len, MAX_NEW, SEED)
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(
        "cuda", torch.int64)
    return reqs, tokens


def prefill_logits(torch, cfg, params, tokens, context=CONTEXT, frames=None,
                   **changes):
    """Last logits [B,1,V] in f32 of the engine's prefill, with the config
    fields in ``changes`` replaced; for the encoder-decoder the encoder
    runs first over ``frames``."""
    from repro_torch.models import registry
    c = dataclasses.replace(cfg, **changes)
    with torch.inference_mode():
        caches = registry.init_caches(c, tokens.shape[0], context, "cuda")
        if frames is not None:
            registry.prefill_encoder(params, c, {"frames": frames}, caches)
        out, _ = registry.prefill_caches(params, c, tokens, caches)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{cfg.name} prefill {changes}: non-finite")
    return out.float()


def rel_err(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def check_attn_prefill(torch, cfg, params, tokens, context=CONTEXT) -> dict:
    rel = rel_err(prefill_logits(torch, cfg, params, tokens, context,
                                 attn_impl="pallas"),
                  prefill_logits(torch, cfg, params, tokens, context,
                                 attn_impl="xla"))
    print(f"[serving] {cfg.name} prefill last logits, flash vs plain: rel "
          f"err {rel:.3e} (tol {PREFILL_REL_TOL})", flush=True)
    if not rel < PREFILL_REL_TOL:
        raise AssertionError(f"prefill logits disagree: rel err {rel}")
    return {"prefill_kernel_vs_plain_rel_err": rel}


class RouteCount:
    """Launches of a kernel module by route inside a ``with`` block, held
    to ``want`` on leaving it."""

    def __init__(self, mod, want: dict, what: str):
        self.mod, self.want, self.what = mod, want, what

    def __enter__(self):
        self.before = dict(self.mod.launches_by_route)

    def __exit__(self, *exc):
        moved = {r: self.mod.launches_by_route[r] - self.before[r]
                 for r in self.before}
        if exc[0] is None and moved != self.want:
            raise AssertionError(f"{self.what}: launches by route {moved}, "
                                 f"want {self.want}")


def check_ssm_prefill(torch, cfg, params, tokens) -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed_tokens, rmsnorm
    from repro_torch.models.module import cast_tree
    p32 = cast_tree(params, torch.float32)
    # f32 x goes to the CUDA-core kernel, bf16 x to the wgmma kernel
    with RouteCount(ssd, {"sm90": 0, "simt": cfg.n_layers},
                    "f32 prefill on the SSD kernel"):
        logits32 = prefill_logits(torch, cfg, p32, tokens, ssm_impl="pallas")
    rel32 = rel_err(logits32,
                    prefill_logits(torch, cfg, p32, tokens, ssm_impl="xla"))
    del p32
    torch.cuda.empty_cache()
    print(f"[serving] {cfg.name} prefill last logits on f32 weights, SSD "
          f"kernel vs plain: rel err {rel32:.3e} (tol "
          f"{SSM_PREFILL_F32_REL_TOL})", flush=True)
    if not rel32 < SSM_PREFILL_F32_REL_TOL:
        raise AssertionError(f"f32 prefill logits disagree: rel err {rel32}")
    kernel = dataclasses.replace(cfg, ssm_impl="pallas")
    plain = dataclasses.replace(cfg, ssm_impl="xla")
    rels = []
    with torch.inference_mode(), RouteCount(
            ssd, {"sm90": cfg.n_layers, "simt": 0},
            "bf16 mixers on the SSD kernel"):
        x = embed_tokens(params, tokens, cfg)
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in params["layers"].items()}
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            ref = ssm.ssm_forward(lp, h, plain)
            out = ssm.ssm_forward(lp, h, kernel)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"layer {i}: non-finite mixer output")
            rels.append(rel_err(out.float(), ref.float()))
            x = x + ref
    worst = max(range(len(rels)), key=rels.__getitem__)
    print(f"[serving] {cfg.name} bf16 mixer output, SSD kernel vs plain, "
          f"layer by layer: max rel err {rels[worst]:.3e} at layer {worst}, "
          f"median {float(np.median(rels)):.3e} (tol {SSM_LAYER_REL_TOL})",
          flush=True)
    if not rels[worst] < SSM_LAYER_REL_TOL:
        raise AssertionError(f"bf16 layer {worst}: kernel vs plain rel err "
                             f"{rels[worst]}")
    return {"prefill_f32_kernel_vs_plain_rel_err": rel32,
            "layer_bf16_kernel_vs_plain_max_rel_err": rels[worst]}


#: zamba2's f32 last logits are also compared at this depth, 2 groups of
#: 6 and a tail of 3 (see check_hybrid_prefill)
HYBRID_LOGITS_LAYERS = 15


def hybrid_block_errors(torch, cfg, params, tokens, exact_attention=False
                        ) -> dict[str, list[float]]:
    """Each block of the zamba2 stack on the kernels, fed the plain path's
    residual stream, against the plain path's block, relative to the
    block's largest output: every Mamba2 mixer ("mamba2 mixer") and every
    shared-attention output ("shared attention").  With
    ``exact_attention`` the shared attention is held instead against the
    flash kernel's plain version (attention_ref, f32 scores) on the block's
    own q/k/v, and its distance to the plain path is kept under "plain
    path"."""
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import attention, hybrid, ssm
    from repro_torch.models.layers import embed_tokens
    kernel = dataclasses.replace(cfg, attn_impl="pallas", ssm_impl="pallas")
    plain = dataclasses.replace(cfg, attn_impl="xla", ssm_impl="xla")
    shared = params["shared_attn"]
    positions = torch.arange(tokens.shape[1], device="cuda").expand(
        tokens.shape)
    rels = {"mamba2 mixer": [], "shared attention": [], "plain path": []}

    def held(kind, out, ref):
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{kind} {len(rels[kind])}: non-finite")
        rels[kind].append(rel_err(out.float(), ref.float()))
        return ref

    def attend(h, g):
        ref = attention.mha_full(shared, h, plain, positions)
        if not exact_attention:
            return held("shared attention",
                        attention.mha_full(shared, h, kernel, positions), ref)
        q, k, v = attention._project_qkv(shared, h, cfg, positions)
        out = attention._out_proj(flash_mha(q, k, v, causal=True),
                                  shared["wo"])
        exact = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                              causal=True).transpose(1, 2)
        held("shared attention", out,
             attention._out_proj(exact, shared["wo"]))
        rels["plain path"].append(rel_err(out.float(), ref.float()))
        return ref

    with torch.inference_mode():
        hybrid.walk(params, cfg, embed_tokens(params, tokens, cfg),
                    lambda lp, h, stack, i: held(
                        "mamba2 mixer", ssm.ssm_forward(lp, h, kernel),
                        ssm.ssm_forward(lp, h, plain)), attend)
    return rels


def check_blocks(cfg, rels, tol, what) -> dict:
    """Each kind of block in ``rels`` (all but "plain path") held to
    ``tol``, its worst and median printed."""
    out = {}
    for kind in (k for k in rels if k != "plain path"):
        errs = rels[kind]
        worst = max(range(len(errs)), key=errs.__getitem__)
        print(f"[serving] {cfg.name} {what} {kind} output, kernel vs plain, "
              f"block by block: max rel err {errs[worst]:.3e} at block "
              f"{worst} of {len(errs)}, median {float(np.median(errs)):.3e} "
              f"(tol {tol})", flush=True)
        if not errs[worst] < tol:
            raise AssertionError(f"{what} {kind} {worst}: kernel vs plain rel "
                                 f"err {errs[worst]}")
        out[f"{what}_{kind.replace(' ', '_')}_max_rel_err"] = errs[worst]
    return out


def check_hybrid_prefill(torch, cfg, params, tokens) -> dict:
    """zamba2, held block by block, as mamba2's bf16 mixers are.  On the
    weights cast to f32 (both CUDA-core kernels): each of the 81 Mamba2
    mixers and 13 shared-attention outputs against the plain path.  The
    last prefill logits are compared but held to no limit: the reference's
    init draws wq and wk at scale 1/sqrt(n_heads), so without qk-norm the
    random model's scores are in the hundreds and each shared-attention
    application multiplies a perturbation by about as much.  Beside the
    kernels-vs-plain distance at HYBRID_LOGITS_LAYERS layers and at full
    depth, two plain paths that differ only in the SSD chunk are compared
    at HYBRID_LOGITS_LAYERS layers, which shows how far the sum order alone
    moves the logits.  On the bf16 weights (both wgmma kernels), block by
    block: each Mamba2
    mixer against the plain mixer, each shared-attention output against the
    same block with the flash kernel's plain version (attention_ref) on the
    same bf16 q/k/v.  The model's plain attention, like the reference's,
    rounds the scores to bf16 before the softmax, one step being ~1 at
    these scores, so it is no measure of the kernel; its distance is
    printed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.module import cast_tree
    n_groups = cfg.n_layers // cfg.attn_every
    p32 = cast_tree(params, torch.float32)
    # f32 goes to both CUDA-core kernels
    with RouteCount(fa, {"sm90": 0, "simt": n_groups},
                    "f32 shared attention on the flash kernel"), \
            RouteCount(ssd, {"sm90": 0, "simt": cfg.n_layers},
                       "f32 mixers on the SSD kernel"):
        out = check_blocks(cfg, hybrid_block_errors(torch, cfg, p32, tokens),
                           SSM_PREFILL_F32_REL_TOL, "f32")
    m = cfg.attn_every
    cut = dataclasses.replace(cfg, n_layers=HYBRID_LOGITS_LAYERS)
    n_cut = HYBRID_LOGITS_LAYERS // m * m
    p_cut = {**p32,
             "mamba_layers": {k: v[:n_cut]
                              for k, v in p32["mamba_layers"].items()},
             "mamba_tail": {k: v[:HYBRID_LOGITS_LAYERS - n_cut]
                            for k, v in p32["mamba_tail"].items()}}
    for c, p in ((cut, p_cut), (cfg, p32)):
        plain_logits = prefill_logits(torch, c, p, tokens, attn_impl="xla",
                                      ssm_impl="xla")
        rels = {"kernels vs plain": rel_err(prefill_logits(
            torch, c, p, tokens, attn_impl="pallas", ssm_impl="pallas"),
            plain_logits)}
        if c is cut:
            rels["plain at chunk 128 vs plain"] = rel_err(prefill_logits(
                torch, c, p, tokens, attn_impl="xla", ssm_impl="xla",
                ssm_chunk=128), plain_logits)
        for what, rel in rels.items():
            key = what.replace(" ", "_")
            out[f"prefill_f32_{c.n_layers}_layers_{key}_rel_err"] = rel
            print(f"[serving] {cfg.name} prefill last logits on f32 weights "
                  f"at {c.n_layers} layers, {what}: rel err {rel:.3e} (no "
                  f"limit)", flush=True)
    del p32, p_cut
    torch.cuda.empty_cache()

    with RouteCount(fa, {"sm90": n_groups, "simt": 0},
                    "bf16 shared attention on the flash kernel"), \
            RouteCount(ssd, {"sm90": cfg.n_layers, "simt": 0},
                       "bf16 mixers on the SSD kernel"):
        rels = hybrid_block_errors(torch, cfg, params, tokens,
                                   exact_attention=True)
    out.update(check_blocks(cfg, rels, SSM_LAYER_REL_TOL, "bf16"))
    out["bf16_shared_attention_vs_plain_path_max_rel_err"] = max(
        rels["plain path"])
    print(f"[serving] {cfg.name} bf16 shared attention output, kernel vs "
          f"the plain path (scores rounded to bf16): max rel err "
          f"{max(rels['plain path']):.3e}, median "
          f"{float(np.median(rels['plain path'])):.3e} (no limit)",
          flush=True)
    return out


#: whisper's f32 last logits are held on the weights with every
#: attention's wq and wk scaled by this factor (see check_whisper_prefill)
AUDIO_QK_SCALE = 0.1


def whisper_block_errors(torch, cfg, params, tokens, caches, exact=False
                         ) -> dict[str, list[float]]:
    """Each decoder layer's self attention over the prompt on the flash
    kernel, fed the plain path's residual stream (cross attention over the
    cross K/V in ``caches``), against the plain path's, relative to the
    layer's largest output ("self attention").  With ``exact`` it is held
    instead against the flash kernel's plain version (attention_ref, f32
    scores) on the layer's own q/k/v, and its distance to the plain path
    is kept under "plain path"."""
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import attention, encdec
    kernel = dataclasses.replace(cfg, attn_impl="pallas")
    plain = dataclasses.replace(cfg, attn_impl="xla")
    positions = torch.arange(tokens.shape[1], device="cuda").expand(
        tokens.shape)
    rels = {"self attention": [], "plain path": []}

    def self_attend(lp, h, i):
        ref = attention.mha_full(lp, h, plain, positions)
        if exact:
            q, k, v = attention._project_qkv(lp, h, cfg, positions,
                                             rope=False)
            out = attention._out_proj(flash_mha(q, k, v, causal=True),
                                      lp["wo"])
            want = attention._out_proj(attention_ref(
                *(t.transpose(1, 2) for t in (q, k, v)), causal=True
            ).transpose(1, 2), lp["wo"])
            rels["plain path"].append(rel_err(out.float(), ref.float()))
        else:
            out, want = attention.mha_full(lp, h, kernel, positions), ref
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"decoder layer {i}: non-finite")
        rels["self attention"].append(rel_err(out.float(), want.float()))
        return ref

    with torch.inference_mode():
        x = encdec._embed(params, cfg, tokens)
        encdec.walk(params, plain, x, self_attend,
                    encdec._cached_cross(caches, x.dtype))
    return rels


def check_whisper_prefill(torch, cfg, params, tokens) -> dict:
    """whisper-medium's prefill, the decoder's self attention on the flash
    kernel, on random frames from a numpy seed.  On the weights cast to f32
    (the "simt" kernel): each decoder layer's self attention against the
    plain path's, one by one, and the last prefill logits.  The logits are
    held on the same f32 weights with every attention's wq and wk scaled by
    AUDIO_QK_SCALE, and printed with no limit unscaled: the reference's
    init draws wq and wk at 1/sqrt(n_heads) with no qk-norm, so the random
    model's scores are in the hundreds and it is chaotic: kernel and plain,
    which differ only in their sums' order, part by about the logits' size
    at 24 layers (tests/test_torch_encdec.py shows one f32 step on the
    frames moving the logits by more than 5e-3 at two).
    On the bf16 weights (the "sm90" kernel), layer by layer: each self
    attention against the same layer with the flash kernel's plain version
    (attention_ref) on its own bf16 q/k/v; the model's plain attention
    rounds the scores to bf16 before the softmax, so its distance is
    printed only.  The encoder and the cross attention run plain, as in
    the reference."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import registry
    from repro_torch.models.module import cast_tree
    n = cfg.n_layers
    frames = registry.make_dummy_batch(cfg, tokens.shape[0], 1, seed=SEED + 2,
                                       device="cuda")["frames"]
    out = {}
    p32 = cast_tree(params, torch.float32)
    with torch.inference_mode():
        caches = registry.init_caches(cfg, tokens.shape[0], AUDIO_CONTEXT,
                                      "cuda")
        registry.prefill_encoder(p32, cfg, {"frames": frames.float()},
                                 caches)
    with RouteCount(fa, {"sm90": 0, "simt": n},
                    "f32 self attention on the flash kernel"):
        rels = whisper_block_errors(torch, cfg, p32, tokens, caches)
    out.update(check_blocks(cfg, rels, SSM_PREFILL_F32_REL_TOL, "f32"))
    scaled = {**p32, **{stack: {**p32[stack],
                                "wq": p32[stack]["wq"] * AUDIO_QK_SCALE,
                                "wk": p32[stack]["wk"] * AUDIO_QK_SCALE}
                        for stack in ("encoder", "decoder", "cross")}}
    for scale, p in ((1.0, p32), (AUDIO_QK_SCALE, scaled)):
        with RouteCount(fa, {"sm90": 0, "simt": n},
                        "f32 prefill on the flash kernel"):
            logits = prefill_logits(torch, cfg, p, tokens, AUDIO_CONTEXT,
                                    frames.float(), attn_impl="pallas")
        rel = rel_err(logits, prefill_logits(
            torch, cfg, p, tokens, AUDIO_CONTEXT, frames.float(),
            attn_impl="xla"))
        held = scale != 1.0
        out[f"prefill_f32_qk_scale_{scale}_kernel_vs_plain_rel_err"] = rel
        print(f"[serving] {cfg.name} prefill last logits on f32 weights, "
              f"wq and wk scaled by {scale}, flash kernel vs plain: rel err "
              f"{rel:.3e} "
              f"({f'tol {SSM_PREFILL_F32_REL_TOL}' if held else 'no limit'})",
              flush=True)
        if held and not rel < SSM_PREFILL_F32_REL_TOL:
            raise AssertionError(f"f32 prefill logits disagree: rel err {rel}")
    del p32, scaled, caches
    torch.cuda.empty_cache()

    with torch.inference_mode():
        caches = registry.init_caches(cfg, tokens.shape[0], AUDIO_CONTEXT,
                                      "cuda")
        registry.prefill_encoder(params, cfg, {"frames": frames}, caches)
    with RouteCount(fa, {"sm90": n, "simt": 0},
                    "bf16 self attention on the flash kernel"):
        rels = whisper_block_errors(torch, cfg, params, tokens, caches,
                                    exact=True)
    out.update(check_blocks(cfg, rels, SSM_LAYER_REL_TOL, "bf16"))
    worst = max(rels["plain path"])
    out["bf16_self_attention_vs_plain_path_max_rel_err"] = worst
    print(f"[serving] {cfg.name} bf16 self attention output, kernel vs the "
          f"plain path (scores rounded to bf16): max rel err {worst:.3e}, "
          f"median {float(np.median(rels['plain path'])):.3e} (no limit)",
          flush=True)
    return out


#: phase 4e: the remaining dense and VLM configs, at their published
#: widths and depths, on phase 4's traffic, but gemma3-27b, whose 8 prompts
#: of 1536 tokens in a context of 2048 cut every local layer's window of
#: 1024 in the prefill and in each decode step
DENSE_ARCHS = ("qwen3-1.7b", "gemma-2b", "gemma3-27b", "pixtral-12b")
DENSE_TRAFFIC = {"gemma3-27b": (1536, 2048)}


def dense_layer_errors(torch, cfg, params, tokens) -> dict[str, list[float]]:
    """Each layer's self attention on the flash kernel, fed the plain
    path's residual stream, against the flash kernel's plain version
    (attention_ref, f32 scores) on the layer's own q/k/v with the layer's
    window, relative to the layer's largest output after the output
    projection ("self attention"); its distance to the model's plain
    attention is kept under "plain path"."""
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import attention, transformer
    from repro_torch.models.layers import mlp, rmsnorm
    plain = dataclasses.replace(cfg, attn_impl="xla")
    positions = torch.arange(tokens.shape[1], device="cuda").expand(
        tokens.shape)
    rels = {"self attention": [], "plain path": []}
    with torch.inference_mode():
        x = transformer._embed(params, cfg, tokens, None)
        for lp, (window, chunk) in zip(
                transformer.layer_views(params["layers"]),
                transformer._layer_masks(cfg)):
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            q, k, v = attention._project_qkv(lp, h, cfg, positions)
            out = attention._out_proj(
                flash_mha(q, k, v, causal=True, window=window), lp["wo"])
            want = attention._out_proj(attention_ref(
                *(t.transpose(1, 2) for t in (q, k, v)), causal=True,
                window=window).transpose(1, 2), lp["wo"])
            ref = attention.mha_full(lp, h, plain, positions, window=window,
                                     chunk=chunk)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"layer {len(rels['plain path'])}: "
                                     f"non-finite")
            rels["self attention"].append(rel_err(out.float(), want.float()))
            rels["plain path"].append(rel_err(out.float(), ref.float()))
            x = x + ref
            x = x + mlp(lp, rmsnorm(x, lp["norm2"], cfg.norm_eps), plain)
    return rels


def check_dense_prefill(torch, cfg, params, tokens, context=CONTEXT) -> dict:
    """A dense or VLM model's bf16 prefill, self attention on the flash
    kernel ("sm90"), held layer by layer: each self attention against
    attention_ref on its own q/k/v (dense_layer_errors), the model's plain
    attention, which rounds the scores to bf16 before the softmax, printed
    beside with no limit.  Then the last prefill logits, flash against
    plain: with qk-norm (qwen3, gemma3) at PREFILL_REL_TOL.  Without it
    (gemma-2b, pixtral) the reference's init draws wq [d, H, D] and wk
    [d, KH, D] at a fan-in of their heads axis, 1/sqrt(H) and 1/sqrt(KH)
    (gemma-2b's single KV head: wk at scale 1), so the random model's
    scores are in the hundreds and it is chaotic, as zamba2 and whisper
    are (check_hybrid_prefill, check_whisper_prefill): the logits are
    printed with no limit as drawn, and held at PREFILL_REL_TOL on the
    weights with wq and wk rescaled to the fan-in d_model (by sqrt(H / d)
    and sqrt(KH / d)), which gives q and k unit entries and the scores
    O(1), as in a trained model.  pixtral's registry.prefill with its 256
    bf16 stub patches is compared the same way."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import registry
    n = cfg.n_layers
    with RouteCount(fa, {"sm90": n, "simt": 0},
                    "bf16 self attention on the flash kernel"):
        rels = dense_layer_errors(torch, cfg, params, tokens)
    out = check_blocks(cfg, rels, SSM_LAYER_REL_TOL, "bf16")
    worst = max(rels["plain path"])
    out["bf16_self_attention_vs_plain_path_max_rel_err"] = worst
    print(f"[serving] {cfg.name} bf16 self attention output, kernel vs the "
          f"plain path (scores rounded to bf16): max rel err {worst:.3e}, "
          f"median {float(np.median(rels['plain path'])):.3e} (no limit)",
          flush=True)
    if cfg.qk_norm:
        out.update(check_attn_prefill(torch, cfg, params, tokens, context))
        return out
    layers = params["layers"]
    scaled = {**params, "layers": {
        **layers, "wq": layers["wq"] * math.sqrt(cfg.n_heads / cfg.d_model),
        "wk": layers["wk"] * math.sqrt(cfg.n_kv_heads / cfg.d_model)}}
    patches = None
    if cfg.family == "vlm":
        patches = registry.make_dummy_batch(
            cfg, tokens.shape[0], 1, seed=SEED + 3, device="cuda")["patches"]
    for fan_in, p in (("as_drawn", params), ("d_model", scaled)):
        held = p is scaled
        with RouteCount(fa, {"sm90": n, "simt": 0},
                        "bf16 prefill on the flash kernel"):
            logits = prefill_logits(torch, cfg, p, tokens, context,
                                    attn_impl="pallas")
        checks = {"prefill": rel_err(logits, prefill_logits(
            torch, cfg, p, tokens, context, attn_impl="xla"))}
        if patches is not None:
            batch = {"tokens": tokens, "patches": patches}
            got = {}
            with torch.inference_mode():
                for impl in ("pallas", "xla"):
                    c = dataclasses.replace(cfg, attn_impl=impl)
                    got[impl] = registry.prefill(p, c, batch).float()
            checks["prefill_with_patches"] = rel_err(got["pallas"],
                                                     got["xla"])
        for what, rel in checks.items():
            out[f"{what}_qk_fan_in_{fan_in}_kernel_vs_plain_rel_err"] = rel
            print(f"[serving] {cfg.name} {what.replace('_', ' ')} last "
                  f"logits, wq and wk "
                  f"{'at fan-in d_model' if held else 'as drawn'}, flash vs "
                  f"plain: rel err {rel:.3e} "
                  f"({f'tol {PREFILL_REL_TOL}' if held else 'no limit'})",
                  flush=True)
            if held and not rel < PREFILL_REL_TOL:
                raise AssertionError(f"{what} logits disagree: rel err {rel}")
    del scaled
    torch.cuda.empty_cache()
    return out


def phase_dense(torch, counters, arch, gen, clock) -> list[dict]:
    """4e: one dense or VLM config at full width and depth on freed memory:
    its init's own peak memory, then phase_serving with every prefill
    layer on the flash kernel's sm90 route (gemma3-27b's 52 local layers
    with their window), for gemma3-27b then phase 4g on the same weights,
    then the f32 smoke config's tokens on both paths.  Returns the serving
    stats of each ServeEngine.run (plain, then 4g's variants)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry, transformer
    from repro_torch.models.module import param_bytes
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen.manual_seed(SEED)
    params, _ = registry.init_params(gen, cfg)
    torch.cuda.synchronize()
    init = {"weights_gib": param_bytes(params) / 2**30,
            "init_max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30}
    print(f"[serving] {arch}: {init['weights_gib']:.3f} GiB of bf16 "
          f"weights, init peak {init['init_max_memory_allocated_gib']:.3f} "
          f"GiB", flush=True)
    prompt_len, context = DENSE_TRAFFIC.get(arch, (PROMPT_LEN, CONTEXT))
    n = cfg.n_layers
    n_windowed = sum(w is not None for w, _ in transformer._layer_masks(cfg))
    serving = phase_serving(
        torch, counters, cfg, params,
        functools.partial(check_dense_prefill, context=context),
        {"flash_attention": n, "ssd_scan": 0},
        {"flash_attention": {"sm90": n, "simt": 0},
         "ssd_scan": {"sm90": 0, "simt": 0}},
        prompt_len=prompt_len, context=context, want_windowed=n_windowed)
    serving.update(init)
    runs = [serving]
    if arch == VARIANT_ARCH:
        with clock(f"4g {arch} cache variants"):
            runs += phase_cache_variants(torch, counters, cfg, params,
                                         serving, prompt_len, context)
    del params
    torch.cuda.empty_cache()
    phase_smoke_tokens(torch, arch, ("attn_impl",))
    return runs


#: phase 4g: the reference's decode cache variants (the windowed ring on
#: the local layers, the int8 cache), served on phase 4e's gemma3-27b
#: weights and traffic
VARIANT_ARCH = "gemma3-27b"
CACHE_VARIANTS = {"windowed_cache": "windowed", "kv_quant": "int8"}
#: decode steps teacher-forced on the plain run's tokens, each variant's
#: logits held against plain decode's
VARIANT_DECODE_STEPS = 8
#: int8 decode logits vs plain: the reference's own limit for its int8
#: cache (tests/test_sharding_and_layers.py:222-240); the windowed ring is
#: held at phase 4e's bf16 limit, PREFILL_REL_TOL
INT8_LOGITS_REL_TOL = 0.02


def variant_logits(torch, cfg, params, tokens, feed, context, check):
    """The engine's prefill into ``cfg``'s cache, every layer on the flash
    kernel's sm90 route (the local ones with their window), then
    ``check(caches)`` on the filled cache, then len(feed[0]) decode steps
    fed ``feed`` [B, n] at positions S.. (teacher forcing).  Returns the
    last logits of the prefill and of each step, f32 [B, V], and what
    ``check`` returned."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import registry, transformer
    n = cfg.n_layers
    n_windowed = sum(w is not None for w, _ in transformer._layer_masks(cfg))
    with torch.inference_mode():
        caches = registry.init_caches(cfg, tokens.shape[0], context, "cuda")
        windowed = fa.windowed_launches
        with RouteCount(fa, {"sm90": n, "simt": 0},
                        f"{cfg.name} prefill into {sorted(caches)}"):
            logits, caches = registry.prefill_caches(params, cfg, tokens,
                                                     caches)
        if fa.windowed_launches - windowed != n_windowed:
            raise AssertionError("windowed flash launches "
                                 f"{fa.windowed_launches - windowed}")
        out = [logits[:, -1].float()]
        checks = check(caches)
        s = tokens.shape[1]
        for i in range(feed.shape[1]):
            lg, caches = registry.decode_step(params, cfg, feed[:, i:i + 1],
                                              s + i, caches)
            out.append(lg[:, -1].float())
        del caches
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return out, checks


def check_ring(torch, cfg, caches, plain, s) -> dict:
    """Each local layer's ring slot p mod W equals the plain cache's
    position p bit for bit for p in [S-W, S); each global layer's cache
    equals the plain cache's layer at [0, S)."""
    from repro_torch.models import transformer
    kinds = {"ring": 0, "plain": 0}
    for i in range(cfg.n_layers):
        kind, (k, v) = transformer._layer_cache(caches, cfg, i)
        kinds[kind] += 1
        for got, want in ((k, plain["k"][i]), (v, plain["v"][i])):
            if kind == "ring":
                w = got.shape[1]
                pos = torch.arange(max(0, s - w), s, device="cuda")
                same = torch.equal(got[:, pos % w], want[:, pos])
            else:
                same = torch.equal(got[:, :s], want[:, :s])
            if not same:
                raise AssertionError(f"layer {i} ({kind}): the cache "
                                     f"differs from the plain cache's")
    print(f"[4g] windowed: {kinds['ring']} rings of "
          f"{caches['local_k'].shape[3]} slots equal the plain cache's last "
          f"positions bit for bit, {kinds['plain']} global caches equal "
          f"the plain cache's layers", flush=True)
    n_local = sum(w is not None for w, _ in transformer._layer_masks(cfg))
    if kinds != {"ring": n_local, "plain": cfg.n_layers - n_local}:
        raise AssertionError(f"layout {kinds}, {n_local} local layers")
    return {"ring_layers": kinds["ring"], "global_layers": kinds["plain"]}


@contextlib.contextmanager
def recorded_quantizer(attention, steps: list):
    """Records, for each quantize_kv call inside the block, the largest
    |dequantize_kv(codes, scale) - x| in scale steps over its (token,
    head) rows."""
    quantize = attention.quantize_kv

    def record(x):
        codes, scale = quantize(x)
        err = (codes.float() * scale - x.float()).abs() / scale
        steps.append(float(err.max()))
        return codes, scale

    attention.quantize_kv = record
    try:
        yield
    finally:
        attention.quantize_kv = quantize


def check_int8(torch, caches, plain, s, quantizer_steps) -> dict:
    """Every layer's stored K/V against the K/V it quantized: within half
    a scale step (round to nearest; ``quantizer_steps`` from
    recorded_quantizer).  The first layer, whose input is the plain run's,
    dequantized against the plain cache: within one scale step per (token,
    head).  The later layers' distance to the plain cache is printed in
    scale steps with no limit: their inputs differ from the plain run's by
    the int8 attention of the layers before."""
    worst_quant = max(quantizer_steps)
    dist = []
    for name in ("k", "v"):
        codes, scales = caches[f"{name}_q"][:, :, :s], \
            caches[f"{name}_s"][:, :, :s]
        for i in range(codes.shape[0]):
            err = (codes[i].float() * scales[i]
                   - plain[name][i][:, :s].float()).abs() / scales[i]
            dist.append(float(err.max()))
    n = len(dist) // 2
    first = max(dist[0], dist[n])
    later = max(dist[1:n] + dist[n + 1:])
    print(f"[4g] int8: {len(quantizer_steps)} quantize_kv calls, worst "
          f"|dequantized - quantized input| {worst_quant:.4f} scale steps "
          f"(limit 0.5); layer 0 vs the plain cache {first:.4f} steps "
          f"(limit 1); layers 1..{n - 1} vs the plain cache up to "
          f"{later:.3f} steps (no limit)", flush=True)
    if len(quantizer_steps) != 2 * n or not worst_quant <= 0.5 + 1e-3:
        raise AssertionError(f"quantizer: {worst_quant} steps over "
                             f"{len(quantizer_steps)} calls")
    if not first <= 1.0:
        raise AssertionError(f"int8 layer 0: {first} scale steps from the "
                             f"plain cache")
    return {"int8_quantizer_max_steps": worst_quant,
            "int8_layer0_vs_plain_max_steps": first,
            "int8_later_layers_vs_plain_max_steps": later}


def phase_cache_variants(torch, counters, cfg, params, plain_serving,
                         prompt_len, context) -> list[dict]:
    """4g: gemma3-27b's decode cache variants on phase 4e's weights and
    traffic.  The plain prefill and VARIANT_DECODE_STEPS decode steps
    teacher-forced on the plain run's tokens give the reference; each
    variant's prefill (62 sm90 flash launches, 52 windowed) fills its
    cache as check_ring or check_int8 holds it, and its teacher-forced
    logits are held to plain decode's (windowed at PREFILL_REL_TOL, int8 at
    INT8_LOGITS_REL_TOL).  Then ServeEngine.run with each variant and
    with the plain cache again (the launches counted as phase_serving
    counts them), and decode ms/step and the serving peaks of plain, both
    variants and plain again side by side."""
    from repro_torch.core.memory.accountant import pytree_nbytes
    from repro_torch.models import attention, registry
    _, tokens = serving_requests(torch, cfg, prompt_len)
    s = tokens.shape[1]
    feed = torch.tensor([g[:VARIANT_DECODE_STEPS]
                         for g in plain_serving["generated"]],
                        dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        plain = registry.init_caches(cfg, tokens.shape[0], context, "cuda")
        logits, plain = registry.prefill_caches(params, cfg, tokens, plain)
        ref = [logits[:, -1].float()]
        # the decode steps write positions S.., which no check reads
        for i in range(feed.shape[1]):
            lg, plain = registry.decode_step(params, cfg, feed[:, i:i + 1],
                                             s + i, plain)
            ref.append(lg[:, -1].float())
    configs = {name: dataclasses.replace(cfg, **{flag: True})
               for flag, name in CACHE_VARIANTS.items()}
    checks = {}
    for flag, name in CACHE_VARIANTS.items():
        c = configs[name]
        steps: list[float] = []
        if flag == "kv_quant":
            with recorded_quantizer(attention, steps):
                out, held = variant_logits(
                    torch, c, params, tokens, feed, context,
                    lambda caches: check_int8(torch, caches, plain, s,
                                              steps))
            tol = INT8_LOGITS_REL_TOL
        else:
            out, held = variant_logits(
                torch, c, params, tokens, feed, context,
                lambda caches: check_ring(torch, c, caches, plain, s))
            tol = PREFILL_REL_TOL
        rels = [rel_err(o, r) for o, r in zip(out, ref)]
        print(f"[4g] {name}: last logits vs plain, prefill then "
              f"{len(rels) - 1} teacher-forced decode steps: rel err "
              f"{', '.join(f'{r:.3e}' for r in rels)} (tol {tol})",
              flush=True)
        if not max(rels) < tol:
            raise AssertionError(f"{name} logits disagree with plain "
                                 f"decode's: {rels}")
        checks[name] = {**held, "logits_vs_plain_rel_err": rels}
    del plain, ref
    torch.cuda.empty_cache()

    n = cfg.n_layers
    runs = {"plain": plain_serving}
    # plain again after the variants: decode ms/step moves between runs
    # (host-bound), so plain is timed on both sides of them
    configs = {"plain": cfg, **configs, "plain again": cfg}
    for name in list(configs)[1:]:
        runs[name] = phase_serving(
            torch, counters, configs[name], params,
            lambda *a, held=checks.get(name, {}): held,
            {"flash_attention": n, "ssd_scan": 0},
            {"flash_attention": {"sm90": n, "simt": 0},
             "ssd_scan": {"sm90": 0, "simt": 0}},
            prompt_len=prompt_len, context=context,
            want_windowed=plain_serving["flash_windowed_launches"],
            run=f"{cfg.name} {name}")
    plain_peak = plain_serving["max_memory_allocated_gb"]
    for name, c in configs.items():
        r = runs[name]
        r["cache_gib"] = pytree_nbytes(registry.init_caches(
            c, N_REQ, context, "meta")) / 2**30
        print(f"[4g] {cfg.name} {name:<11} cache {r['cache_gib']:.3f} GiB: "
              f"prefill {r['prefill_ms']:.2f} ms, decode "
              f"{r['decode_ms_per_step']:.2f} ms/step, peak "
              f"{r['accountant_peak_in_use_gb']:.3f} GiB (accountant) / "
              f"{r['max_memory_allocated_gb']:.3f} GiB (allocator), "
              f"{r['max_memory_allocated_gb'] - plain_peak:+.3f} GiB vs "
              f"plain", flush=True)
        if name in checks and not r["max_memory_allocated_gb"] < plain_peak:
            raise AssertionError(f"{name}: serving peak not below plain's")
    return [runs[name] for name in list(configs)[1:]]


#: tokens a moe_layer call takes in the MoE check: at S=1 its dispatch
#: holds [E, tokens, k, d_ff] activations (llama4: 128 x 256 x 8192)
MOE_CHECK_TOKENS = 256
#: the MoE check holds the card's routes to the CPU's on the same bf16
#: inputs: the two f32 router products differ only in the order of their
#: sums (~1e-7 in a probability), so a route may differ only at a token
#: whose k-th and next expert's CPU probabilities lie closer than this
ROUTE_TIE = 1e-5


@contextlib.contextmanager
def recorded_routes(moe):
    """The experts [tokens, k] of every ``moe.top_k_gates`` call made
    inside the block, in call order (moe_tokens and moe_layer both route
    through it)."""
    calls = []
    real = moe.top_k_gates

    def record(probs, k):
        gates, experts = real(probs, k)
        calls.append(experts.reshape(-1, k))
        return gates, experts

    moe.top_k_gates = record
    try:
        yield calls
    finally:
        moe.top_k_gates = real


def moe_layer_errors(torch, cfg, params, tokens) -> dict[str, list[float]]:
    """Each layer of a MoE config, fed the plain path's residual stream:
    its self attention on the flash kernel (the layers without a chunk;
    llama4's chunked layers are plain on both paths) against the flash
    kernel's plain version (attention_ref, f32 scores) on its own q/k/v
    ("self attention"), its distance to the model's plain attention kept
    under "plain path"; and each MoE layer's moe_tokens, as the engine runs
    it, against moe_layer with every token a group of one, MOE_CHECK_TOKENS
    tokens a call, on the same bf16 inputs ("moe").  Relative to each
    output's largest entry.  Both route through ``moe.top_k_routes`` on the
    same tensor, so that comparison covers the dispatch and combine
    arithmetic on the card, not the routing; the card's routes are held
    instead to the CPU's, computed from the same bf16 inputs and router:
    a route may differ only at a near tie (ROUTE_TIE).  Returns the errors
    and, for each MoE layer, the tokens whose routes differ from the CPU's
    and the tokens at a near tie."""
    from repro_torch.kernels.ops import flash_mha
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import attention, moe, transformer
    from repro_torch.models.layers import mlp, rmsnorm
    plain = dataclasses.replace(cfg, attn_impl="xla")
    positions = torch.arange(tokens.shape[1], device="cuda").expand(
        tokens.shape)
    rels = {"self attention": [], "plain path": [], "moe": []}
    routes = []

    def held(kind, out, want):
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{kind} {len(rels[kind])}: non-finite")
        rels[kind].append(rel_err(out.float(), want.float()))

    with torch.inference_mode():
        x = transformer._embed(params, cfg, tokens, None)
        layers = transformer.layer_views(params["layers"])
        for lp, (is_moe, fp), (window, chunk) in zip(
                layers, transformer.layer_ffns(layers, params, cfg),
                transformer._layer_masks(cfg)):
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            ref = attention.mha_full(lp, h, plain, positions, window=window,
                                     chunk=chunk)
            if chunk is None:
                q, k, v = attention._project_qkv(lp, h, cfg, positions)
                out = attention._out_proj(
                    flash_mha(q, k, v, causal=True, window=window), lp["wo"])
                held("self attention", out, attention._out_proj(
                    attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                  causal=True, window=window).transpose(1, 2),
                    lp["wo"]))
                rels["plain path"].append(rel_err(out.float(), ref.float()))
            x = x + ref
            hn = rmsnorm(x, lp["norm2"], cfg.norm_eps)
            if not is_moe:
                x = x + mlp(fp, hn, cfg)
                continue
            flat = hn.reshape(-1, cfg.d_model)
            outs, wants = [], []
            for part in flat.split(MOE_CHECK_TOKENS):
                outs.append(moe.moe_tokens(fp, part, cfg))
                wants.append(moe.moe_layer(fp, part[:, None], cfg)[0][:, 0])
            out = torch.cat(outs)
            held("moe", out, torch.cat(wants))
            x = x + out.reshape(x.shape)
            k = cfg.top_k
            card = moe.top_k_routes(fp, flat, cfg)[1].sort(-1).values.cpu()
            top = moe.router_probs({"router": fp["router"].cpu()},
                                   flat.cpu()).topk(k + 1, dim=-1)
            tie = top.values[:, k - 1] - top.values[:, k] < ROUTE_TIE
            differ = (card != top.indices[:, :k].sort(-1).values).any(-1)
            layer = {"differ": int(differ.sum()), "near_tie": int(tie.sum())}
            if bool((differ & ~tie).any()):
                raise AssertionError(f"MoE layer {len(routes)}: routes on the "
                                     f"card differ from the CPU's beyond a "
                                     f"near tie: {layer}")
            routes.append(layer)
    return rels, routes


def check_moe_prefill(torch, cfg, params, tokens) -> dict:
    """A MoE config's bf16 prefill (moe_layer_errors, layer by layer: the
    flash layers' self attention at SSM_LAYER_REL_TOL against
    attention_ref, each MoE layer's moe_tokens at SSM_LAYER_REL_TOL against
    moe_layer at S=1, its routes on the card against the CPU's), then the
    last prefill logits,
    flash against plain, as drawn (no limit: without qk-norm the random
    init's scores are in the hundreds, see check_dense_prefill) and on wq
    and wk rescaled to the fan-in d_model.  Top-k routing is discontinuous,
    so the two paths' last-ulp differences flip some tokens' routes; each
    MoE layer's flipped tokens are counted and printed.  A flip at a token
    reaches another token's logits only through attention, spread over the
    prompt, while it moves its own token's logits by O(1); and over 4096
    tokens some flip in every request (a gap between the k-th and the next
    expert's probability below the ~1e-3 noise is a few tokens in a
    thousand).  So the rescaled logits are held at PREFILL_REL_TOL over the
    requests whose last token kept its routes in every MoE layer, and over
    the requests with no flip at all where there are any."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe, transformer
    n_flash = sum(chunk is None for _, chunk in transformer._layer_masks(cfg))
    with RouteCount(fa, {"sm90": n_flash, "simt": 0},
                    "bf16 self attention on the flash kernel"):
        rels, routes = moe_layer_errors(torch, cfg, params, tokens)
    out = check_blocks(cfg, rels, SSM_LAYER_REL_TOL, "bf16")
    out["moe_routes_card_vs_cpu_by_layer"] = routes
    print(f"[serving] {cfg.name} MoE routes on the card vs the CPU on the "
          f"same bf16 inputs, by MoE layer, of {tokens.numel()} tokens: "
          f"{routes} (a route may differ only at a near tie, top-{cfg.top_k} "
          f"probability gap below {ROUTE_TIE})", flush=True)
    worst = max(rels["plain path"])
    out["bf16_self_attention_vs_plain_path_max_rel_err"] = worst
    print(f"[serving] {cfg.name} bf16 self attention output, kernel vs the "
          f"plain path (scores rounded to bf16): max rel err {worst:.3e} "
          f"(no limit)", flush=True)
    layers = params["layers"]
    scaled = {**params, "layers": {
        **layers, "wq": layers["wq"] * math.sqrt(cfg.n_heads / cfg.d_model),
        "wk": layers["wk"] * math.sqrt(cfg.n_kv_heads / cfg.d_model)}}
    b_, s = tokens.shape
    for fan_in, p in (("as_drawn", params), ("d_model", scaled)):
        held = p is scaled
        logits, routes = {}, {}
        for impl in ("pallas", "xla"):
            with recorded_routes(moe) as calls, RouteCount(
                    fa, {"sm90": n_flash if impl == "pallas" else 0,
                         "simt": 0}, f"bf16 prefill at attn_impl {impl}"):
                logits[impl] = prefill_logits(torch, cfg, p, tokens,
                                              attn_impl=impl)[:, -1]
            routes[impl] = [c.sort(-1).values.reshape(b_, s, -1)
                            for c in calls]
        flips = torch.stack([(a != b).any(-1) for a, b in
                             zip(routes["pallas"], routes["xla"])])
        flipped = flips.any(0)                      # [B, S]
        sets = {"all": torch.ones(b_, dtype=torch.bool, device="cuda"),
                "last_token_kept": ~flipped[:, -1],
                "no_flip": ~flipped.any(1)}
        errs = {name: rel_err(logits["pallas"][rows], logits["xla"][rows])
                for name, rows in sets.items() if bool(rows.any())}
        key = f"qk_fan_in_{fan_in}"
        out[f"{key}_flipped_tokens_by_layer"] = flips.sum((1, 2)).tolist()
        out[f"{key}_requests_by_set"] = {n: int(r.sum())
                                         for n, r in sets.items()}
        out.update({f"prefill_{key}_{n}_kernel_vs_plain_rel_err": r
                    for n, r in errs.items()})
        limit = f"tol {PREFILL_REL_TOL}" if held else "no limit"
        print(f"[serving] {cfg.name} prefill last logits, wq and wk "
              f"{'at fan-in d_model' if held else 'as drawn'}, flash vs "
              f"plain: tokens whose top-{cfg.top_k} routes differ, by MoE "
              f"layer, {out[f'{key}_flipped_tokens_by_layer']} of {b_ * s}; "
              f"requests by set {out[f'{key}_requests_by_set']}; rel err "
              + ", ".join(f"{n} {r:.3e}" for n, r in errs.items())
              + f" ({limit} on last_token_kept and no_flip)", flush=True)
        if held and (not errs.get("last_token_kept", 1.0) < PREFILL_REL_TOL
                     or not errs.get("no_flip", 0.0) < PREFILL_REL_TOL):
            raise AssertionError(f"prefill logits disagree: {errs}")
    del scaled
    torch.cuda.empty_cache()
    return out


def phase_moe(torch, counters, arch, gen) -> dict:
    """4f: one MoE config at its published width, cut to ONE_CARD_LAYERS,
    on freed memory: its init's own peak memory, then phase_serving with
    every layer without a chunk on the flash kernel's sm90 route (all of
    grok's, llama4's global layer), then the f32 smoke config's tokens on
    both paths."""
    from repro_torch.configs import ONE_CARD_LAYERS, get_config
    from repro_torch.models import registry, transformer
    from repro_torch.models.module import param_bytes, param_count
    full = get_config(arch)
    cfg = dataclasses.replace(full, attn_impl="pallas",
                              n_layers=ONE_CARD_LAYERS[arch])
    masks = transformer._layer_masks(cfg)
    n_flash = sum(chunk is None for _, chunk in masks)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen.manual_seed(SEED)
    params, _ = registry.init_params(gen, cfg)
    torch.cuda.synchronize()
    n_moe = sum(is_moe for is_moe, _ in transformer.layer_ffns(
        transformer.layer_views(params["layers"]), params, cfg))
    init = {"layers": cfg.n_layers, "published_layers": full.n_layers,
            "params": param_count(params),
            "weights_gib": param_bytes(params) / 2**30,
            "init_max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30}
    print(f"[serving] {arch}: {cfg.n_layers} of its {full.n_layers} layers "
          f"(depth cut to fit one card; d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} KV heads of "
          f"{cfg.resolved_head_dim}, {cfg.n_experts} experts top-"
          f"{cfg.top_k} at d_ff {cfg.d_ff}, vocab {cfg.vocab}, as published)"
          f": {n_moe} MoE layers, {n_flash} on the flash kernel, "
          f"{len(masks) - n_flash} chunked on the plain path; "
          f"{init['params']} params, {init['weights_gib']:.3f} GiB of bf16 "
          f"weights, init peak {init['init_max_memory_allocated_gib']:.3f} "
          f"GiB", flush=True)
    serving = phase_serving(
        torch, counters, cfg, params, check_moe_prefill,
        {"flash_attention": n_flash, "ssd_scan": 0},
        {"flash_attention": {"sm90": n_flash, "simt": 0},
         "ssd_scan": {"sm90": 0, "simt": 0}})
    serving.update(init)
    del params
    torch.cuda.empty_cache()
    phase_smoke_tokens(torch, arch, ("attn_impl",))
    return serving


def phase_serving(torch, counters, cfg, params, check_prefill,
                  want_launches, want_routes, prompt_len=PROMPT_LEN,
                  context=CONTEXT, want_windowed=0, run=None) -> dict:
    """Full-width serving through ServeEngine.run: ``check_prefill`` holds
    the prefill's last logits on the kernel path against the plain path,
    then the run goes with every kernel's launch count set to 0 just
    before it and read just after; ``want_launches`` maps each kernel
    module's name to the launches the run must make, ``want_routes`` each
    module's name to its launches by route, and ``want_windowed`` is the
    flash launches with a sliding window among them.  For the
    encoder-decoder the encoder (over the engine's zero frames) is timed on
    its own before the decoder's prefill.  ``run`` names the run in the
    kernels line (default the arch); the stats returned carry the
    generated tokens under ``generated`` (not printed)."""
    from repro_torch.core.mig_h100 import MigH100Backend
    from repro_torch.models import registry
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    reqs, tokens = serving_requests(torch, cfg, prompt_len)
    checks = check_prefill(torch, cfg, params, tokens)
    timings = {}
    with torch.inference_mode():
        caches = registry.init_caches(cfg, N_REQ, context, "cuda")
        if cfg.family == "audio":
            frames = torch.zeros((N_REQ, cfg.enc_seq, cfg.d_model),
                                 dtype=torch.bfloat16, device="cuda")
            timings["encoder_ms"] = timed_ms(
                torch, lambda: registry.prefill_encoder(
                    params, cfg, {"frames": frames}, caches), n=5, warmup=1)
        timings["prefill_ms"] = timed_ms(
            torch, lambda: registry.prefill_caches(params, cfg, tokens,
                                                   caches), n=5, warmup=1)
        del caches

    # the main path, with the kernels' launch counts read around it
    engine = ServeEngine(cfg, params,
                         EngineConfig(max_batch=N_REQ, max_context=context,
                                      predict=False),
                         backend=MigH100Backend(), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa = counters["flash_attention"]
    for mod in counters.values():
        mod.launches = 0
        mod.launches_by_route = dict.fromkeys(mod.ROUTES, 0)
    fa.windowed_launches = 0
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    routes = {name: dict(mod.launches_by_route)
              for name, mod in counters.items()}
    windowed = fa.windowed_launches
    print(f"[serving] {cfg.name} kernel launches in ServeEngine.run: "
          f"{launches}, by route {routes}, flash with a window {windowed} "
          f"(layers {cfg.n_layers})", flush=True)
    if (launches != want_launches or routes != want_routes
            or windowed != want_windowed):
        raise AssertionError(f"launches {launches}, by route {routes}, "
                             f"windowed {windowed}; want {want_launches}, "
                             f"{want_routes}, {want_windowed}")
    n_tok = sum(len(r.generated) for r in out)
    if n_tok != N_REQ * MAX_NEW or not all(
            0 <= t < cfg.vocab for r in out for t in r.generated):
        raise AssertionError(f"bad generations: {n_tok} tokens")
    if len(engine.accountant.history) != 1 + MAX_NEW:
        raise AssertionError("accountant missed iterations")
    stats = {
        "arch": cfg.name, "run": run or cfg.name, "requests": N_REQ,
        "prompt_len": prompt_len,
        "new_tokens": MAX_NEW, "max_context": context, **timings,
        "run_s": run_s,
        "decode_ms_per_step": (run_s * 1e3 - sum(timings.values()))
        / MAX_NEW,
        "tokens_per_s": n_tok / run_s,
        "accountant_peak_in_use_gb": engine.accountant.peak_in_use / 2**30,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "launches_by_route": routes,
        "flash_windowed_launches": windowed,
        **checks,
    }
    print(f"[serving] {json.dumps(stats)}", flush=True)
    print(f"[serving] req 0: {out[0].generated[:16]}", flush=True)
    stats["generated"] = [list(r.generated) for r in out]
    return stats


def phase_smoke_tokens(torch, arch, impl_fields) -> None:
    """Greedy tokens of the 2-layer smoke config with f32 weights: the
    kernel path and the plain path (every config field of ``impl_fields``
    set to "pallas", or to "xla") must pick the same tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import registry
    from repro_torch.models.module import cast_tree
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = get_smoke_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = cast_tree(registry.init_params(gen, cfg)[0], torch.float32)
    got = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, **dict.fromkeys(impl_fields, impl))
        reqs = make_requests(c, 4, 100, 24, SEED)
        eng = ServeEngine(c, params, EngineConfig(max_batch=4,
                                                  max_context=256,
                                                  predict=False),
                          device="cuda")
        got[impl] = [r.generated for r in eng.run(reqs)]
    if got["pallas"] != got["xla"]:
        raise AssertionError(f"{arch} smoke config: kernel and plain paths "
                             f"generated different tokens")
    print(f"[smoke] {arch} f32 smoke config: identical greedy tokens on both "
          f"{'/'.join(impl_fields)} paths ({sum(map(len, got['xla']))} "
          f"tokens)", flush=True)


def set_launches(entries, serving) -> None:
    """Each kernels-line entry of a shape the served arch calls takes its
    route's launch count from that arch's ServeEngine.run (on the sm90
    route the windowed launches go to the windowed shape, the rest to the
    other); ``launches`` sums the runs of the archs sharing the shape, a
    run of each cache variant included."""
    for entry in entries:
        if serving["arch"] not in entry["archs"]:
            continue
        n = serving["launches_by_route"][entry["name"]][entry["kernel_route"]]
        if entry["name"] == "flash_attention" and \
                entry["kernel_route"] == "sm90":
            windowed = serving["flash_windowed_launches"]
            n = windowed if entry["window"] else n - windowed
        entry.setdefault("launches_by_arch", {})[serving["run"]] = n
        entry["launches"] = sum(entry["launches_by_arch"].values())


#: phase 5b: the reference's leases of three tenants of full-width
#: qwen3-0.6b on the H100 (profile, start GPC, card reachability after)
MT_LEASES = [("1g.10gb", 3, 76), ("1g.10gb", 1, 37), ("1g.10gb", 5, 17)]
MT_REGROWN = "1g.20gb"


def phase_multi_tenant(torch, counters, cfg, params) -> dict:
    """repro_torch.launch.multi_tenant's flow on the card, on phase 4's
    weights, with every kernel's launch count set to 0 just before it and
    read just after: it must lease MT_LEASES, finish every tenant's
    tokens, keep each run's allocator peak within its lease, restart the
    growing tenant early on MT_REGROWN, launch no kernel and leave the
    card's FSM empty."""
    from repro_torch.launch import multi_tenant as mt

    jobs = mt.make_jobs(smoke=False)
    torch.cuda.synchronize()
    print(f"[multi_tenant] resident before the tenants: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    for mod in counters.values():
        mod.launches = 0
        mod.launches_by_route = dict.fromkeys(mod.ROUTES, 0)
    pm, tenants = mt.run_tenants(cfg, params, jobs, "cuda")
    launches = {name: mod.launches for name, mod in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"kernel launches in the multi-tenant flow: "
                             f"{launches}")
    leases = [(t.slices[0].profile, t.slices[0].gpc, t.reach)
              for t in tenants]
    if leases != MT_LEASES:
        raise AssertionError(f"leases {leases}, want {MT_LEASES}")
    if pm.state != pm.backend.initial_state() or pm.live:
        raise AssertionError(f"card not empty at the end: {pm.describe()}")
    stats = []
    for t in tenants:
        if len(t.tokens) != t.job.n_tokens or not all(
                0 <= tok < cfg.vocab for tok in t.tokens):
            raise AssertionError(f"{t.job.name}: {len(t.tokens)} tokens of "
                                 f"{t.job.n_tokens}")
        want = [MT_LEASES[0][0]] + [MT_REGROWN] * t.job.growing
        if [s.profile for s in t.slices] != want:
            raise AssertionError(f"{t.job.name} ran on "
                                 f"{[s.profile for s in t.slices]}, want "
                                 f"{want}")
        flagged = t.slices[0].flagged
        if t.job.growing and not (flagged and flagged.iteration
                                  < t.job.n_tokens - 1):
            raise AssertionError(f"{t.job.name}: no early restart before "
                                 f"its last step")
        for s in t.slices:
            if s.peak_gb > s.lease_gb:
                raise AssertionError(f"{t.job.name} on {s.profile}: "
                                     f"allocator peak {s.peak_gb:.3f} GiB "
                                     f"over its {s.lease_gb} GiB lease")
        row = {"tenant": t.job.name, "batch": t.job.batch,
               "context": t.job.context, "tokens": t.job.n_tokens,
               "reach_after_lease": t.reach,
               "runs": [{"profile": s.profile, "gpc": s.gpc,
                         "lease_gib": s.lease_gb, "steps": s.steps,
                         "ms_per_step": s.ms_per_step,
                         "max_memory_allocated_gib": s.peak_gb}
                        for s in t.slices]}
        if flagged:
            row["restart_step"] = flagged.iteration
            row["predicted_peak_gib"] = flagged.peak_mem_bytes / 2**30
        print(f"[multi_tenant] {json.dumps(row)}", flush=True)
        stats.append(row)
    print(f"[multi_tenant] kernel launches in the flow: {launches}",
          flush=True)
    return {"tenants": stats, "launches": launches}


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


#: phase 6a: qwen3-0.6b's training run, as launch/train.py would make it
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
#: steps timed for tokens/s (the first two warm cuBLAS and the allocator)
TRAIN_TIMED = slice(2, 8)
#: phase 6b: f32 smoke steps on the card against the CPU (the limit of
#: tests/test_torch_training.py's traces against the reference)
PARITY_STEPS, PARITY_BATCH, PARITY_SEQ, PARITY_REL = 3, 2, 64, 1e-4
#: zamba2's random init puts its shared attention's scores in the hundreds,
#: where a change of sum order alone moves its gradient by ~1e-4; its
#: parity trace scales wq and wk by this factor to bring them to O(1)
#: (tests/test_torch_training.py::ZAMBA2_QK_SCALE gives the measurements)
ZAMBA2_QK_SCALE = 0.1


def same_bits(torch, a, b) -> bool:
    with torch.no_grad():
        return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def phase_train(torch, counters) -> dict:
    """6a: qwen3-0.6b at full width through make_train_step, the kernels'
    launch counts set to 0 just before and read just after; then a save
    and load of the final state through training/checkpoint.py."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import param_count, tree_leaves
    from repro_torch.training.checkpoint import (flatten, load_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(gen, cfg)
    start = [p.detach().clone() for p in tree_leaves(state["params"])]
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                               total_steps=TRAIN_STEPS))
    batches = SyntheticLM(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, SEED),
                          "cuda").batches()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    steps = []
    for mod in counters.values():
        mod.launches = 0
        mod.launches_by_route = dict.fromkeys(mod.ROUTES, 0)
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        state, metrics = step_fn(state, batch)
        ev1.record()
        torch.cuda.synchronize()
        rec = {"step": i, "ms": ev0.elapsed_time(ev1),
               "wall_ms": (time.perf_counter() - t0) * 1e3,
               **{k: float(v) for k, v in metrics.items()}}
        steps.append(rec)
        print(f"[train] {cfg.name} step {i}: loss {rec['loss']:.4f} grad "
              f"norm {rec['grad_norm']:.4f} lr {rec['lr']:.2e} "
              f"{rec['ms']:.2f} ms (CUDA events; host {rec['wall_ms']:.2f} "
              f"ms)", flush=True)
        if not (math.isfinite(rec["loss"])
                and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"training step {i}: non-finite {rec}")
    launches = {name: mod.launches for name, mod in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"training launched kernels: {launches}")
    if all(torch.equal(a, b) for a, b in zip(start,
                                             tree_leaves(state["params"]))):
        raise AssertionError("training left every param unchanged")
    del start
    timed = steps[TRAIN_TIMED]
    stats = {
        "arch": cfg.name, "params": param_count(state["params"]),
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "ms_per_step": [r["ms"] for r in steps],
        "timed_steps": [r["step"] for r in timed],
        "tokens_per_s": (TRAIN_BATCH * TRAIN_SEQ * len(timed)
                         / (sum(r["ms"] for r in timed) / 1e3)),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
        / 2**30,
        "launches": launches,
    }
    print(f"[train] {cfg.name}: {stats['params']} params, tokens/s over "
          f"steps {stats['timed_steps'][0]}-{stats['timed_steps'][-1]}: "
          f"{stats['tokens_per_s']:.1f}, max_memory_allocated "
          f"{stats['max_memory_allocated_gib']:.3f} GiB, kernel launches "
          f"{launches}", flush=True)

    path = ROOT / "build" / "chip_smoke" / "train_state.npz"
    t0 = time.perf_counter()
    try:
        save_checkpoint(str(path), state, step=TRAIN_STEPS)
        loaded = load_checkpoint(str(path), state)
    finally:
        for f in (path, Path(str(path) + ".manifest.json")):
            f.unlink(missing_ok=True)
    want, got = flatten(state), flatten(loaded)
    if sorted(want) != sorted(got) or not all(
            same_bits(torch, want[k], got[k]) for k in want):
        raise AssertionError("checkpoint save/load is not bitwise")
    stats["checkpoint_s"] = time.perf_counter() - t0
    print(f"[train] checkpoint of the final state ({len(want)} arrays) "
          f"saved and loaded bit for bit in {stats['checkpoint_s']:.1f} s",
          flush=True)
    print(f"[train] {json.dumps(stats)}", flush=True)
    return stats


def phase_train_parity(torch) -> dict:
    """6b: each smoke config in f32, PARITY_STEPS steps from one initial
    state on the card and on the CPU; loss and grad norm within
    PARITY_REL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry
    from repro_torch.models.module import cast_tree, tree_map
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    worst = {}
    for arch in (ARCH, SSM_ARCH, HYBRID_ARCH):
        cfg = get_smoke_config(arch)
        params = cast_tree(registry.init_params(
            torch.Generator().manual_seed(SEED), cfg)[0], torch.float32)
        if cfg.family == "hybrid":
            for key in ("wq", "wk"):
                params["shared_attn"][key] *= ZAMBA2_QK_SCALE
        step_fn = make_train_step(cfg, AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=PARITY_STEPS))
        trace = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(),
                         params)
            state = {"params": p, "opt": init_opt_state(p)}
            batches = SyntheticLM(cfg, DataConfig(PARITY_BATCH, PARITY_SEQ,
                                                  SEED), dev).batches()
            trace[dev] = []
            for _ in range(PARITY_STEPS):
                state, m = step_fn(state, next(batches))
                trace[dev].append({k: float(m[k])
                                   for k in ("loss", "grad_norm")})
        worst[arch] = max(abs(g[k] - c[k]) / abs(c[k])
                          for c, g in zip(trace["cpu"], trace["cuda"])
                          for k in c)
        print(f"[train] {arch} smoke f32, {PARITY_STEPS} steps, card vs "
              f"CPU: loss {[r['loss'] for r in trace['cuda']]} vs "
              f"{[r['loss'] for r in trace['cpu']]}, max rel err of loss "
              f"and grad norm {worst[arch]:.3e} (tol {PARITY_REL})",
              flush=True)
        if not worst[arch] <= PARITY_REL:
            raise AssertionError(f"{arch}: card and CPU training disagree "
                                 f"(rel {worst[arch]})")
    return worst


def phase_refusal(torch, fa, ssd) -> None:
    """6c: both kernels, on both routes, refuse an input that requires
    grad, before any launch; the same call without grad launches on the
    route."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for mod, route, dtype in ((fa, "sm90", torch.bfloat16),
                              (fa, "simt", torch.float32),
                              (ssd, "sm90", torch.bfloat16),
                              (ssd, "simt", torch.float32)):
        if mod is fa:
            args = [rnd(1, 2, 64, 128).to(dtype) for _ in range(3)]
            call = functools.partial(fa.flash_attention, *args)
        else:
            args = [rnd(1, 64, 2, 64).to(dtype), rnd(1, 64, 2).abs(),
                    -rnd(2).abs(), rnd(1, 64, 128), rnd(1, 64, 128)]
            call = functools.partial(ssd.ssd_scan, *args, chunk=64)
        name = mod.__name__.rsplit(".", 1)[-1]
        for which in range(len(args)):
            args[which].requires_grad_()
            before = dict(mod.launches_by_route)
            try:
                call()
            except RuntimeError as err:
                if "no backward" not in str(err):
                    raise
            else:
                raise AssertionError(f"{name} ({route}) ran on input "
                                     f"{which} that requires grad")
            if mod.launches_by_route != before:
                raise AssertionError(f"{name} ({route}) launched before "
                                     f"refusing")
            args[which].requires_grad_(False)
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        moved = {r: mod.launches_by_route[r] - before[r] for r in before}
        if moved != {r: int(r == route) for r in mod.ROUTES}:
            raise AssertionError(f"{name} without grad: launches {moved}, "
                                 f"want one on {route}")
        print(f"[train] {name} ({route}): refuses each of its {len(args)} "
              f"inputs when it requires grad, launches without", flush=True)


#: phase 7a: the paper's Fig. 4 as repro_torch.launch.fig4 runs it, pinned.
#: (backend, workload) -> each arm's (makespan s, energy J, OOMs, early
#: restarts, reconfigurations), arms in fig4.run_workload's order: baseline,
#: scheme_a, scheme_b (and A+steal on the Ml mixes); on the LLM workloads
#: the full-GPU sequential run, A without and A with the predictor.  These
#: are the simulator's outputs (the device model calibrated to the paper's
#: Tables 3-4, with A100_POWER or H100_POWER), not measurements of a card;
#: tests/test_torch_scheduler.py holds this table against the reference.
FIG4_PINNED = {
    ("a100", "Hm1"): [(171, 15255, 0, 0, 50), (45.26, 8339.3, 0, 0, 7),
        (85.8, 10569, 0, 0, 2)],
    ("a100", "Hm2"): [(190.75, 17803.75, 0, 0, 50), (48.82, 9997.6, 0, 0, 7),
        (54.885, 10331.175, 0, 0, 4)],
    ("a100", "Hm3"): [(447, 25365, 0, 0, 100), (67.35, 4484.25, 0, 0, 7),
        (67.35, 4484.25, 0, 0, 7)],
    ("a100", "Hm4"): [(373, 46840, 0, 0, 50), (194, 36995, 0, 0, 2),
        (194.3, 37011.5, 0, 0, 2)],
    ("a100", "Ht1"): [(74.705, 7759.175, 0, 0, 15),
        (35.8075, 5619.8125, 0, 0, 11), (38.19, 5750.85, 0, 0, 24)],
    ("a100", "Ht2"): [(128.01, 19501.05, 0, 0, 18),
        (90.305, 17427.275, 0, 0, 10), (101.43, 18039.15, 0, 0, 29)],
    ("a100", "Ht3"): [(204.54, 24681.3, 0, 0, 36),
        (106.905, 19311.375, 0, 0, 10), (127.83, 20462.25, 0, 0, 66)],
    ("a100", "Ml1"): [(195.695, 20242.175, 0, 0, 14),
        (101.36, 15053.75, 0, 0, 9), (103.421666667, 15167.1416667, 0, 0, 8),
        (101.36, 15053.75, 0, 0, 9)],
    ("a100", "Ml2"): [(237.45, 21737.25, 0, 0, 21), (97.05, 14015.25, 0, 0, 7),
        (119.9, 15272, 0, 0, 4), (97.05, 14015.25, 0, 0, 7)],
    ("a100", "Ml3"): [(296.91, 32920.65, 0, 0, 18),
        (166.715, 25759.925, 0, 0, 2), (167.015, 25776.425, 0, 0, 2),
        (166.715, 25759.925, 0, 0, 2)],
    ("a100", "qwen2"): [(144.5, 23445.125, 0, 0, 1),
        (360.43, 47367.1214286, 1, 0, 5), (161.77, 25372.6214286, 0, 1, 5)],
    ("a100", "llama3"): [(100.5, 16306.125, 0, 0, 1),
        (236.35, 31362.1214286, 1, 0, 5), (113.15, 17722.1214286, 0, 1, 5)],
    ("a100", "flan_t5_train"): [(482, 78204.5, 0, 0, 4),
        (626, 121010.139286, 4, 0, 5), (545.15, 108412.389286, 0, 4, 5)],
    ("a100", "flan_t5"): [(195, 31638.75, 0, 0, 6),
        (213.48, 47078.4642857, 6, 0, 5), (192.22, 42477.1642857, 0, 6, 5)],
    ("h100", "Hm1"): [(171, 31575, 0, 0, 50), (45.26, 22144.5, 0, 0, 7),
        (85.8, 25185, 0, 0, 2)],
    ("h100", "Hm2"): [(190.75, 37743.75, 0, 0, 50), (48.82, 27099, 0, 0, 7),
        (54.885, 27553.875, 0, 0, 4)],
    ("h100", "Hm3"): [(447, 36025, 0, 0, 100), (67.35, 7551.25, 0, 0, 7),
        (67.35, 7551.25, 0, 0, 7)],
    ("h100", "Hm4"): [(373, 112350, 0, 0, 50), (244.32, 102699, 0, 0, 4),
        (224.26, 101194.5, 0, 0, 3)],
    ("h100", "Ht1"): [(74.705, 17302.875, 0, 0, 15), (32.24, 14118, 0, 0, 9),
        (35.66, 14374.5, 0, 0, 23)],
    ("h100", "Ht2"): [(128.01, 49538.25, 0, 0, 18),
        (85.065, 46317.375, 0, 0, 13), (100.93, 47507.25, 0, 0, 28)],
    ("h100", "Ht3"): [(204.54, 58390.5, 0, 0, 36),
        (101.665, 50674.875, 0, 0, 13), (132.815, 53011.125, 0, 0, 58)],
    ("h100", "Ml1"): [(195.695, 45058.375, 0, 0, 14),
        (86.825, 36893.125, 0, 0, 11), (123.095, 39613.375, 0, 0, 9),
        (86.645, 36879.625, 0, 0, 11)],
    ("h100", "Ml2"): [(237.45, 45621.25, 0, 0, 21), (97.05, 35091.25, 0, 0, 7),
        (119.9, 36805, 0, 0, 4), (97.05, 35091.25, 0, 0, 7)],
    ("h100", "Ml3"): [(296.91, 75443.25, 0, 0, 18),
        (162.87, 65390.25, 0, 0, 4), (168.545, 65815.875, 0, 0, 3),
        (130.865, 62989.875, 0, 0, 4)],
    ("h100", "qwen2"): [(144.5, 60509.375, 0, 0, 1),
        (708.46, 141211.285714, 1, 0, 11), (311.14, 75937.2857143, 0, 1, 11)],
    ("h100", "llama3"): [(100.5, 42084.375, 0, 0, 1),
        (463.6, 93421.7857143, 1, 0, 11), (217.2, 52941.7857143, 0, 1, 11)],
    ("h100", "flan_t5_train"): [(482, 201837.5, 0, 0, 4),
        (786.4, 335926.428571, 4, 0, 11), (709.4, 304026.428571, 0, 4, 11)],
    ("h100", "flan_t5"): [(195, 81656.25, 0, 0, 6),
        (217.4, 128794.285714, 6, 0, 11), (193.06, 115968.785714, 0, 6, 11)],
}
#: makespan and energy are held at this relative error (Python's float sum
#: may move the last bits between interpreters); the counts exactly
FIG4_REL = 1e-9
#: the headline figures, each derived from the table: Hm3 scheme A's gain
#: over the baseline on the A100 (throughput, energy), and qwen2 on the
#: A100 with the predictor (makespan s, early restarts, OOMs) against
#: without it, each as (value, decimals) as the benches print them
FIG4_HEADLINES = {"Hm3 scheme_a thpt x": (6.64, 2),
                  "Hm3 scheme_a energy x": (5.66, 2),
                  "qwen2 predict makespan s": (161.8, 1),
                  "qwen2 no-predict makespan s": (360.4, 1)}
#: phase 7b: the traced scheme B run of Hm3 on the A100 (with the
#: predictor, as the reference's regret bench traces it), graded by the
#: oracle at this node budget
TRACE_MIX, ORACLE_NODE_BUDGET = "Hm3", 200_000
TRACE_PINNED = {"oracle_makespan_s": 64.5, "oracle_exact": True,
                "makespan_regret_s": 2.85, "graded": 193, "diverged": 14,
                "worst_decision_regret_s": 4.3}
#: phase 7c: the reference regret gate's single-device arms and mixes;
#: EPS is the gate's own slack, one oracle duration quantum (the oracle
#: floors durations to integer microseconds); the DP must prove its optimum
#: on at least MIN_EXACT of the mixes; a graded decision's regret is held
#: at DECISION_EPS (Q and V are read over the same DP node)
REGRET_MIXES, REGRET_EPS = ("Hm3", "Hm4", "Ht1"), 1e-6
REGRET_MIN_EXACT, DECISION_EPS = 2, 1e-9


def close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b))


def check_fig4(backend: str, out: dict) -> int:
    """Every arm of every workload against FIG4_PINNED; the number of
    arms checked."""
    from repro_torch.launch import fig4

    n = 0
    for workload in fig4.WORKLOADS:
        want = FIG4_PINNED[(backend, workload)]
        got = [(m.makespan, m.energy_j, m.n_oom, m.n_early_restarts,
                m.n_reconfigs) for m in out[workload].values()]
        if len(got) != len(want) or not all(
                close(g[0], w[0], FIG4_REL) and close(g[1], w[1], FIG4_REL)
                and g[2:] == w[2:] for g, w in zip(got, want)):
            raise AssertionError(f"Fig. 4 {backend} {workload}: {got}, "
                                 f"pinned {want}")
        n += len(got)
    return n


def phase_scheduler(counters, card: str) -> dict:
    """7: the paper's batch scheduler through the port's entry points, on
    the host of the card's machine (the scheduler models the device; it
    launches nothing on it): (a) Fig. 4 on both MIG geometries against
    FIG4_PINNED, (b) a traced Hm3 scheme B run through the flight recorder
    and the regret oracle against TRACE_PINNED, (c) the regret gate.  The
    kernels' launch counts are set to 0 before and must stay there."""
    import tempfile

    from repro_torch.core.mig_a100 import make_backend as make_a100
    from repro_torch.core.planner.oracle import (BatchOracle,
                                                 classes_from_jobs,
                                                 classes_from_specs,
                                                 energy_lower_bound_j)
    from repro_torch.core.scheduler.energy import A100_POWER, H100_POWER
    from repro_torch.core.scheduler.policies import (run_baseline,
                                                     run_scheme_a,
                                                     run_scheme_b)
    from repro_torch.launch import fig4
    from repro_torch.obs import Tracer, read_jsonl, write_chrome_trace
    from repro_torch.obs.replay import load_replay, trace_regret

    for mod in counters.values():
        mod.launches = 0
        mod.launches_by_route = dict.fromkeys(mod.ROUTES, 0)
    seconds = {}

    # 7a. Fig. 4, every workload and arm, on both MIG geometries
    t0 = time.perf_counter()
    figs = {}
    for name, (make_backend, power) in fig4.BACKENDS.items():
        rows: list = []
        figs[name] = fig4.run(rows, backend=make_backend(), power=power)
        n = check_fig4(name, figs[name])
        print(f"[scheduler] Fig. 4 on {name}: {n} arms of "
              f"{len(fig4.WORKLOADS)} workloads equal the pinned table "
              f"(rel {FIG4_REL}, counts exact); {len(rows)} rows", flush=True)
    hm3, qwen2 = figs["a100"]["Hm3"], figs["a100"]["qwen2"]
    thpt, energy, _, _ = fig4.ratios(hm3["scheme_a"], hm3["baseline"])
    pred, nopred = qwen2["A (predict)"], qwen2["A (no predict)"]
    headlines = {"Hm3 scheme_a thpt x": thpt, "Hm3 scheme_a energy x": energy,
                 "qwen2 predict makespan s": pred.makespan,
                 "qwen2 no-predict makespan s": nopred.makespan}
    for key, (want, decimals) in FIG4_HEADLINES.items():
        if round(headlines[key], decimals) != want:
            raise AssertionError(f"{key}: {headlines[key]}, want {want}")
    if (pred.n_early_restarts, pred.n_oom, nopred.n_oom) != (1, 0, 1):
        raise AssertionError(f"qwen2: predict {pred.n_early_restarts} early "
                             f"/ {pred.n_oom} OOM, no-predict {nopred.n_oom} "
                             f"OOM, want 1 / 0, 1")
    print(f"[scheduler] headlines (the simulator's, A100 model): "
          f"{json.dumps(headlines)}", flush=True)
    seconds["7a"] = time.perf_counter() - t0

    # 7b. the flight recorder on a traced run, graded by the oracle
    t0 = time.perf_counter()
    backend = make_a100()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.jsonl")
        with Tracer(meta={"policy": "scheme_b", "mix": TRACE_MIX},
                    sink=path) as tracer:
            traced = run_scheme_b(fig4.rodinia_mix(TRACE_MIX), backend,
                                  A100_POWER, tracer=tracer)
        plain = run_scheme_b(fig4.rodinia_mix(TRACE_MIX), backend,
                             A100_POWER)
        if dataclasses.asdict(traced) != dataclasses.asdict(plain):
            raise AssertionError("the traced run's Metrics differ from the "
                                 "untraced run's")
        header, records = read_jsonl(path)
        chrome = str(Path(tmp) / "trace.chrome.json")
        write_chrome_trace(chrome, records, header["meta"])
        n_events = len(json.loads(Path(chrome).read_text())["traceEvents"])
        replay = load_replay(path)
        reg = trace_regret(replay, node_budget=ORACLE_NODE_BUDGET)
    if (classes_from_specs(replay.jobs)
            != classes_from_jobs(fig4.rodinia_mix(TRACE_MIX))):
        raise AssertionError("the trace's job classes differ from the mix's")
    graded = [d for d in reg.decisions if d.regret_s is not None]
    got = {"oracle_makespan_s": reg.oracle.makespan_s,
           "oracle_exact": reg.oracle.exact,
           "makespan_regret_s": reg.makespan_regret_s,
           "graded": len(graded),
           "diverged": sum(1 for d in graded if d.diverged),
           "worst_decision_regret_s": max(d.regret_s for d in graded)}
    print(f"[scheduler] traced {TRACE_MIX} scheme_b: {len(records)} records "
          f"({header['meta']}), {n_events} Chrome trace events, Metrics "
          f"equal to the untraced run's; regret vs the oracle: "
          f"{json.dumps(got)}", flush=True)
    for key, want in TRACE_PINNED.items():
        ok = (got[key] == want if isinstance(want, (bool, int))
              else close(got[key], want, FIG4_REL))
        if not ok:
            raise AssertionError(f"trace regret {key}: {got[key]}, pinned "
                                 f"{want}")
    if min(d.regret_s for d in graded) < -DECISION_EPS:
        raise AssertionError("a graded decision's regret is negative")
    seconds["7b"] = time.perf_counter() - t0

    # 7c. the regret gate: the oracle bounds every arm's makespan and the
    # admissible bound its energy, and scheme B is no further from the
    # oracle than the baseline; 7b's oracle solved TRACE_MIX already
    t0 = time.perf_counter()
    gate = {}
    for mix in REGRET_MIXES:
        classes = classes_from_jobs(fig4.rodinia_mix(mix))
        oracle = (reg.oracle if mix == TRACE_MIX else
                  BatchOracle(backend, classes,
                              node_budget=ORACLE_NODE_BUDGET).solve())
        energy_lb = energy_lower_bound_j(A100_POWER, classes,
                                         oracle.makespan_s)
        arms = {"baseline": run_baseline(fig4.rodinia_mix(mix), backend,
                                         A100_POWER),
                "scheme_a": run_scheme_a(fig4.rodinia_mix(mix), backend,
                                         A100_POWER, use_prediction=False),
                "scheme_b": run_scheme_b(fig4.rodinia_mix(mix), backend,
                                         A100_POWER)}
        regret = {arm: m.makespan - oracle.makespan_s
                  for arm, m in arms.items()}
        energy_regret = {arm: m.energy_j - energy_lb
                         for arm, m in arms.items()}
        gate[mix] = {"oracle_s": oracle.makespan_s, "exact": oracle.exact,
                     "regret_s": regret, "energy_regret_j": energy_regret}
        print(f"[scheduler] regret gate {mix}: {json.dumps(gate[mix])}",
              flush=True)
        if min(regret.values()) < -REGRET_EPS:
            raise AssertionError(f"{mix}: an arm beats the oracle's bound")
        if min(energy_regret.values()) < -REGRET_EPS:
            raise AssertionError(f"{mix}: an arm's energy beats the "
                                 f"admissible bound")
        if regret["scheme_b"] > regret["baseline"] + REGRET_EPS:
            raise AssertionError(f"{mix}: scheme_b's regret exceeds the "
                                 f"baseline's")
    n_exact = sum(g["exact"] for g in gate.values())
    if n_exact < REGRET_MIN_EXACT:
        raise AssertionError(f"the oracle's DP was exact on {n_exact} of "
                             f"{len(gate)} mixes, want {REGRET_MIN_EXACT}")
    seconds["7c"] = time.perf_counter() - t0

    launches = {name: mod.launches for name, mod in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"kernel launches in the scheduler: {launches}")
    print(f"[scheduler] kernel launches in the phase: {launches}; host "
          f"seconds {json.dumps(seconds)}", flush=True)
    print(f"[scheduler] power: H100_POWER.p_peak_w {H100_POWER.p_peak_w} W "
          f"(the model's figure, {H100_POWER.name}); the card's power limit "
          f"{card.split(',')[-1].strip()} (nvidia-smi, {card})", flush=True)
    return {"gate": gate, "trace": got, "seconds": seconds}


def phase_host_sims(counters) -> dict:
    """8: the paper's request-level LLM serving simulator and the fleet
    through the port's launchers on the host of the card's machine (both
    model the devices and launch nothing on them): launch/serving_sim.py's
    8 arms (A100 and H100, full / static / dynamic / dynamic+pred) at the
    reference bench's traffic, 300 Poisson requests at 2.0/s, seed 11,
    and launch/fleet_sim.py's 12 (three fleet shapes, four routers), each
    with the reference bench's checks, which raise.  Every goodput,
    latency and Joule printed is the simulator's (the LLMServingModel
    coefficients, the scheduler's device model), not the card's; only the
    seconds are the machine's.  The kernels' launch counts are set to 0
    before and must stay there."""
    from repro_torch.launch import fleet_sim, serving_sim
    for mod in counters.values():
        mod.launches = 0
        mod.launches_by_route = dict.fromkeys(mod.ROUTES, 0)
    seconds, rows = {}, {}
    for name, launcher in (("serving_sim", serving_sim),
                           ("fleet_sim", fleet_sim)):
        t0 = time.perf_counter()
        rows[name] = []
        launcher.run(rows[name])
        seconds[name] = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"kernel launches in the host sims: {launches}")
    print(f"[host sims] the launchers' checks hold; {len(rows['serving_sim'])}"
          f" serving and {len(rows['fleet_sim'])} fleet rows (the "
          f"simulator's figures, not the card's); kernel launches "
          f"{launches}; host seconds {json.dumps(seconds)}", flush=True)
    return {"seconds": seconds}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ONE_CARD_LAYERS, get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ops import flash_mha, ssd_mixer
    from repro_torch.kernels.ref import attention_ref, ssd_ref
    from repro_torch.models import registry
    from repro_torch.models.ssm import ssd_chunked

    # plain versions in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clock = PhaseClock()

    # 1. card
    with clock("1 card"):
        card = card_line()
        print(f"[card] {card}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}", flush=True)

    # 2. build every kernel source, all nvcc processes at once
    with clock("2 build"):
        built = build.build()
        print(f"[build] {sorted(built)}", flush=True)
        for res in built.values():
            for line in res.log.splitlines():
                print(f"[build] {res.name}: {line.strip()}", flush=True)

    # 3. each kernel against its plain version
    with clock("3 kernels"):
        flash = phase_kernels(torch, fa, flash_mha, attention_ref)
        scan = phase_ssd_kernel(torch, ssd, ssd_mixer, ssd_ref, ssd_chunked)
    counters = {"flash_attention": fa, "ssd_scan": ssd}

    # 4. full-width qwen3 serving on the flash prefill
    with clock("4 qwen3 serving"):
        phase_smoke_tokens(torch, ARCH, ("attn_impl",))
        cfg = dataclasses.replace(get_config(ARCH), attn_impl="pallas")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        params, _ = registry.init_params(gen, cfg)
        serving = phase_serving(
            torch, counters, cfg, params, check_attn_prefill,
            {"flash_attention": cfg.n_layers, "ssd_scan": 0},
            {"flash_attention": {"sm90": cfg.n_layers, "simt": 0},
             "ssd_scan": {"sm90": 0, "simt": 0}})
        set_launches(flash, serving)

    # 5. early restart and regrow (serve prints each restart line)
    with clock("5 restart"):
        phase_restart(cfg, params)

    # 5b. the multi-tenant MIG flow on phase 4's weights, no kernel
    with clock("5b multi-tenant"):
        phase_multi_tenant(torch, counters, cfg, params)

    # 4b. full-width mamba2 serving on the SSD prefill, on its own memory
    with clock("4b mamba2 serving"):
        del params
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(SSM_ARCH), ssm_impl="pallas")
        gen.manual_seed(SEED)
        params, _ = registry.init_params(gen, cfg)
        serving = phase_serving(
            torch, counters, cfg, params, check_ssm_prefill,
            {"flash_attention": 0, "ssd_scan": cfg.n_layers},
            {"flash_attention": {"sm90": 0, "simt": 0},
             "ssd_scan": {"sm90": cfg.n_layers, "simt": 0}})
        set_launches(scan, serving)
        del params
        torch.cuda.empty_cache()
        phase_smoke_tokens(torch, SSM_ARCH, ("ssm_impl",))

    # 4c. full-width zamba2 serving on both kernels, on its own memory
    with clock("4c zamba2 serving"):
        cfg = dataclasses.replace(get_config(HYBRID_ARCH), attn_impl="pallas",
                                  ssm_impl="pallas")
        gen.manual_seed(SEED)
        params, _ = registry.init_params(gen, cfg)
        n_groups = cfg.n_layers // cfg.attn_every
        serving = phase_serving(
            torch, counters, cfg, params, check_hybrid_prefill,
            {"flash_attention": n_groups, "ssd_scan": cfg.n_layers},
            {"flash_attention": {"sm90": n_groups, "simt": 0},
             "ssd_scan": {"sm90": cfg.n_layers, "simt": 0}})
        set_launches(flash + scan, serving)
        del params
        torch.cuda.empty_cache()
        phase_smoke_tokens(torch, HYBRID_ARCH, ("attn_impl", "ssm_impl"))

    # 4d. full-width whisper serving, the decoder's prefill on the flash
    # kernel, on its own memory
    with clock("4d whisper serving"):
        cfg = dataclasses.replace(get_config(AUDIO_ARCH), attn_impl="pallas")
        gen.manual_seed(SEED)
        params, _ = registry.init_params(gen, cfg)
        serving = phase_serving(
            torch, counters, cfg, params, check_whisper_prefill,
            {"flash_attention": cfg.n_layers, "ssd_scan": 0},
            {"flash_attention": {"sm90": cfg.n_layers, "simt": 0},
             "ssd_scan": {"sm90": 0, "simt": 0}},
            prompt_len=AUDIO_PROMPT_LEN, context=AUDIO_CONTEXT)
        set_launches(flash, serving)
        del params
        torch.cuda.empty_cache()
        phase_smoke_tokens(torch, AUDIO_ARCH, ("attn_impl",))

    # 4e. the remaining dense and VLM configs at full width and depth, the
    # prefill on the flash kernel, each on its own memory
    for arch in DENSE_ARCHS:
        with clock(f"4e {arch} serving"):
            for run in phase_dense(torch, counters, arch, gen, clock):
                set_launches(flash, run)

    # 4f. the MoE configs at full width, cut in depth to fit the card, the
    # flash kernel on every layer without a chunk, each on its own memory
    for arch in ONE_CARD_LAYERS:
        with clock(f"4f {arch} serving"):
            set_launches(flash, phase_moe(torch, counters, arch, gen))

    # 6. training on the plain path: full-width qwen3, card vs CPU parity,
    # and the kernels' refusal of autograd
    with clock("6 training"):
        phase_train(torch, counters)
        phase_train_parity(torch)
        phase_refusal(torch, fa, ssd)

    # 7. the paper's batch scheduler on the host: Fig. 4 on both MIG
    # geometries, the flight recorder and the regret oracle, no kernel
    with clock("7 scheduler"):
        phase_scheduler(counters, card)

    # 8. the serving simulator and the fleet on the host, no kernel
    with clock("8 serving simulator and fleet"):
        phase_host_sims(counters)

    print(f"[time] {json.dumps(clock.seconds)}", flush=True)
    print(json.dumps({"kernels": [*flash, *scan]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
