"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes, on ``meta`` tensors, and extract memory, op-count,
collective and roofline figures.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape decode_32k [--multi-pod] [--all] [--out experiments/dryrun]
        [--sites]

The port's counterpart of the reference's ``repro/launch/dryrun.py``.
Where the reference lowers and compiles each step with XLA for 256 or 512
forced host devices, this builds the params, optimizer moments, batch and
caches as DTensors of ``meta`` local shards on a ``DeviceMesh`` over a fake
process group (:mod:`repro_torch.launch.mesh`), placed by the reference's
rules (:mod:`repro_torch.sharding.partitioning`), and runs the step once
under :func:`repro_torch.launch.op_count.analyze`.  It is host code: it
allocates nothing and never claims a card.  The prefill and decode kinds
run under ``torch.no_grad``; the train kind runs the port's
``train_step`` (loss, backward, AdamW) at the preset's microbatches.
Each config runs at its own ``attn_impl``; a ``pallas`` one fails, since
no kernel runs on ``meta``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory.static_estimator import (
    active_param_count, activation_bytes_train, kv_cache_bytes, param_count)
from repro_torch.core.memory.workspace import scratch_bytes
from repro_torch.launch.analysis import (ROOFLINE_HEADER, Roofline,
                                         analytic_hbm_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_count import COLLECTIVES, analyze
from repro_torch.launch.shapes import (SHAPES, ShapePreset, applicable,
                                       cache_shapes, input_specs)
from repro_torch.models import registry
from repro_torch.sharding.partitioning import (LONG_CONTEXT_OVERRIDES,
                                               active_act_rules,
                                               apply_policy, placements_for,
                                               spec_for)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import make_train_step

BIG_PARAM_THRESHOLD = 50e9  # bf16 optimizer moments above this

#: gradient-accumulation depth overrides: the >=300B MoE models and
#: gemma3-27b train at microbatch 16 (activation carries halve)
MICRO_OVERRIDES = {"grok-1-314b": 16, "llama4-maverick-400b-a17b": 16,
                   "gemma3-27b": 16}


# -- sharding helpers ---------------------------------------------------------


def _shard_tree(tree, specs, mesh, rules, long_context):
    """``meta`` tensors -> DTensors placed by their logical-axis specs."""
    from torch.distributed.tensor import distribute_tensor
    ov = LONG_CONTEXT_OVERRIDES if long_context else None
    if isinstance(tree, dict):
        return {k: _shard_tree(v, specs[k], mesh, rules, long_context)
                for k, v in tree.items()}
    spec = spec_for(tuple(specs), mesh, tuple(tree.shape), rules, ov)
    return distribute_tensor(tree, mesh, placements_for(spec, mesh))


def _replicated(t, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    return distribute_tensor(t, mesh, [Replicate()] * mesh.ndim)


def _param_state(cfg: ModelConfig):
    """(params on ``meta``, spec tree) without allocating anything."""
    return registry.init_params(None, cfg, device="meta")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -- per-kind tracing ------------------------------------------------------------


def trace_train(cfg: ModelConfig, preset: ShapePreset, mesh,
                policy: str = "baseline", sites: bool = False) -> dict:
    prules, arules = apply_policy(policy)
    params, specs = _param_state(cfg)
    big = param_count(cfg) > BIG_PARAM_THRESHOLD / 2
    mdtype = torch.bfloat16 if big else torch.float32
    moments = _map(lambda p: torch.empty(p.shape, dtype=mdtype,
                                         device="meta"), params)
    p_sh = _map(lambda p: p.requires_grad_(),
                _shard_tree(params, specs, mesh, prules, False))
    state = {"params": p_sh,
             "opt": {"m": _shard_tree(moments, specs, mesh, prules, False),
                     "v": _shard_tree(moments, specs, mesh, prules, False),
                     "step": _replicated(torch.empty(
                         (), dtype=torch.int32, device="meta"), mesh)}}
    batch = _shard_tree(input_specs(cfg, preset),
                        registry.batch_specs(cfg, with_labels=True), mesh,
                        arules, False)
    step = make_train_step(cfg, AdamWConfig(),
                           n_microbatches=preset.microbatches)
    return _trace(step, arules, sites, state, batch)


def trace_prefill(cfg: ModelConfig, preset: ShapePreset, mesh,
                  policy: str = "baseline", sites: bool = False) -> dict:
    prules, arules = apply_policy(policy)
    params, specs = _param_state(cfg)
    p_sh = _shard_tree(params, specs, mesh, prules, False)
    batch = _shard_tree(input_specs(cfg, preset),
                        registry.batch_specs(cfg, with_labels=False), mesh,
                        arules, preset.long_context)

    @torch.no_grad()
    def fn(p, b):
        return registry.prefill(p, cfg, b)
    return _trace(fn, arules, sites, p_sh, batch)


def trace_decode(cfg: ModelConfig, preset: ShapePreset, mesh,
                 policy: str = "baseline", sites: bool = False) -> dict:
    """One decode step at the last position of a full cache.  MoE layers
    dispatch by capacity, as the reference's ``decode_step`` does (the
    engine's dropless ``moe_tokens`` counts tokens per expert on the host,
    which ``meta`` tensors cannot)."""
    prules, arules = apply_policy(policy)
    params, specs = _param_state(cfg)
    p_sh = _shard_tree(params, specs, mesh, prules, False)
    caches = _shard_tree(cache_shapes(cfg, preset), registry.cache_specs(cfg),
                         mesh, arules, preset.long_context)
    tok = _shard_tree(torch.empty((preset.batch, 1), dtype=torch.int64,
                                  device="meta"), ("batch", None), mesh,
                      arules, preset.long_context)

    @torch.no_grad()
    def fn(p, t, c):
        return registry.decode_step(p, cfg, t, preset.seq - 1, c,
                                    capacity_moe=True)
    return _trace(fn, arules, sites, p_sh, tok, caches)


def _trace(fn, act_rules, sites, *args) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    with active_act_rules(act_rules), implicit_replication():
        return analyze(fn, *args, sites=sites)


TRACE = {"train": trace_train, "prefill": trace_prefill,
         "decode": trace_decode}


# -- the dry run over (arch, shape, mesh) ---------------------------------------


@dataclasses.dataclass
class DryRunResult:
    """One combo's figures, per device.

    ``argument_bytes`` is the local shards' bytes of everything the step
    takes; ``output_bytes`` its results' and ``alias_bytes`` those results
    that are arguments updated in place (the train state, the decode
    caches: the reference's donated buffers).  ``temp_bytes`` is
    :func:`~repro_torch.core.memory.workspace.scratch_bytes`: the eager
    path's own working set above its arguments (q-blocked plain attention
    at ``attn_impl="xla"``, per-layer checkpointing in training; outputs
    live at the peak included), not the reference's XLA buffer assignment.
    So ``per_device_bytes`` is ``argument_bytes + temp_bytes``, the peak.
    ``flops``, ``collectives`` and ``parsed_out_bytes`` are
    :mod:`~repro_torch.launch.op_count`'s; ``model_flops`` and
    ``hbm_bytes`` the reference's analytic figures.  ``compile_s`` is the
    host seconds of the trace.  With ``sites``, ``sites``, ``largest``
    and ``peak_temps`` are op_count's attribution of the collectives and
    of the working set at the peak to the port's code.
    """
    arch: str
    shape: str
    mesh: str
    ok: bool
    policy: str = "baseline"
    skipped: str = ""
    error: str = ""
    compile_s: float = 0.0
    per_device_bytes: int = 0
    argument_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    flops: float = 0.0            # dispatch-counted, per device
    n_ops: int = 0
    hbm_bytes: float = 0.0        # analytic per-device traffic (memory term)
    parsed_out_bytes: float = 0.0 # per-op output bytes (diagnostic)
    collectives: dict | None = None
    model_flops: float = 0.0
    sites: dict | None = None
    largest: dict | None = None
    peak_temps: list | None = None


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def run_combo(arch: str, shape: str | ShapePreset, multi_pod: bool = False,
              policy: str = "baseline",
              microbatches: int | None = None,
              config_overrides: dict | None = None,
              mesh=None, sites: bool = False) -> DryRunResult:
    """Trace one (arch, shape) on the production mesh (or ``mesh``)."""
    cfg = get_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    preset = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    res = DryRunResult(arch=arch, shape=preset.name, mesh=mesh_name(mesh),
                       ok=False, policy=policy)

    runs, why = applicable(cfg, preset)
    if not runs:
        res.skipped = why
        return res
    if preset.kind == "train" and arch in MICRO_OVERRIDES:
        preset = dataclasses.replace(preset,
                                     microbatches=MICRO_OVERRIDES[arch])
    if microbatches is not None and preset.kind == "train":
        preset = dataclasses.replace(preset, microbatches=microbatches)

    n_dev = math.prod(mesh.shape)
    t0 = time.time()
    try:
        parsed = TRACE[preset.kind](cfg, preset, mesh, policy=policy,
                                    sites=sites)
        res.compile_s = time.time() - t0
        res.argument_bytes = parsed["argument_bytes"]
        res.output_bytes = parsed["output_bytes"]
        res.alias_bytes = parsed["alias_bytes"]
        res.temp_bytes = scratch_bytes(parsed)
        res.per_device_bytes = res.argument_bytes + res.temp_bytes
        res.flops = parsed["flops"]
        res.n_ops = parsed["n_ops"]
        res.parsed_out_bytes = parsed["out_bytes"]
        res.collectives = parsed["collectives"]
        res.sites = parsed.get("sites")
        res.largest = parsed.get("largest")
        res.peak_temps = parsed.get("peak_temps")
        # analytic useful FLOPs (per device): 6*N*D for train (fwd+bwd),
        # 2*N*D for prefill, 2*N per token for decode
        n_active = active_param_count(cfg)
        n_total = param_count(cfg)
        tokens = preset.batch * (preset.seq if preset.kind != "decode" else 1)
        mult = 6 if preset.kind == "train" else 2
        res.model_flops = mult * n_active * tokens / n_dev
        opt_b = n_total * (2 * 2 if n_total > BIG_PARAM_THRESHOLD / 2
                           else 2 * 4)
        act_b = activation_bytes_train(
            cfg, preset.batch // (preset.microbatches
                                  if preset.kind == "train" else 1),
            preset.seq)
        cache_b = kv_cache_bytes(cfg, preset.batch, preset.seq,
                                 dtype_bytes=1 if cfg.kv_quant else 2)
        res.hbm_bytes = analytic_hbm_bytes(
            cfg, preset, n_dev, params_bytes=n_total * 2,
            opt_bytes=opt_b, cache_bytes=cache_b, act_bytes=act_b)
        res.ok = True
    except Exception as e:
        res.error = f"{type(e).__name__}: {e}"[:2000]
        res.compile_s = time.time() - t0
    return res


def roofline_of(res) -> Roofline:
    get = (lambda k, d=0.0: res.get(k, d)) if isinstance(res, dict) \
        else (lambda k, d=0.0: getattr(res, k, d))
    colls = get("collectives") or {}
    return Roofline(arch=get("arch"), shape=get("shape"), mesh=get("mesh"),
                    hlo_flops=get("flops"), hlo_bytes=get("hbm_bytes"),
                    coll_bytes=colls.get("total", 0),
                    model_flops=get("model_flops"))


def collectives_line(colls: dict) -> str:
    """Bytes and op counts of each collective kind, and their total."""
    counts = colls.get("counts", {})
    return "collectives: " + ", ".join(
        f"{k}={colls[k] / 1e9:.3f}GB ({counts.get(k, 0)})"
        for k in COLLECTIVES if colls.get(k)) + \
        f"  total={colls.get('total', 0) / 1e9:.3f}GB"


def sites_lines(res) -> str:
    """A traced combo's attribution (``run_combo(..., sites=True)``): the
    bytes of each collective kind by code site, the largest single one of
    each kind, and each storage the step made that is live at its peak."""
    out = [f"      site  {k}: {v} B" for k, v in res.sites.items()]
    out.append(f"      largest single collective: {json.dumps(res.largest)}")
    out += [f"      at the peak  {n} B  {what}" for n, what in res.peak_temps]
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=ALL_ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--sites", action="store_true",
                    help="also print each collective's and the peak's "
                         "working set by code site")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    results = []
    print(ROOFLINE_HEADER)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                res = run_combo(arch, shape, mp, sites=args.sites)
                results.append(dataclasses.asdict(res))
                tag = f"{arch} x {shape} x {res.mesh}"
                if res.skipped:
                    print(f"SKIP  {tag}: {res.skipped}")
                elif not res.ok:
                    print(f"FAIL  {tag}: {res.error[:300]}")
                else:
                    print(roofline_of(res).row()
                          + f"  [{res.compile_s:.1f}s trace, "
                          f"{res.per_device_bytes / 2**30:.2f} GiB/dev]")
                    print("      " + collectives_line(res.collectives))
                    if args.sites:
                        print(sites_lines(res))
                with open(os.path.join(args.out, "dryrun.json"), "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["ok"])
    n_skip = sum(1 for r in results if r["skipped"])
    n_fail = len(results) - n_ok - n_skip
    print(f"\n{n_ok} ok / {n_skip} skipped / {n_fail} FAILED "
          f"(results -> {args.out}/dryrun.json)")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
