"""The port's compile-analysis tooling against the reference's, on the CPU:
the sharding rules (``sharding/partitioning.py``), the spec trees of the
registry, the dispatch-level op counts of ``launch/op_count.py`` against
the reference's HLO parser on one-device compiles, the roofline
arithmetic, and sharded dry runs of smoke configs on fake meshes (each in
a subprocess: a fake process group lives as long as its process)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import analysis as ref_analysis
from repro.launch.hlo_parse import analyze as hlo_analyze
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.models import registry as ref_registry
from repro.sharding import partitioning as ref_part
from repro.training.optimizer import AdamWConfig as RefAdamW
from repro.training.train_step import make_train_step as ref_train_step
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core.memory.accountant import spec_nbytes
from repro_torch.core.memory.workspace import scratch_bytes
from repro_torch.launch import analysis, op_count, shapes
from repro_torch.models import registry
from repro_torch.models.layers import padded_vocab
from repro_torch.models.module import stack_specs, tree_map
from repro_torch.sharding import partitioning as part
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 64


class AxisSizes:
    """Just enough of a mesh for either package's ``spec_for``."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = self.axis_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self.devices = np.empty(self.shape, dtype=object)


MESHES = {"16x16": AxisSizes({"data": 16, "model": 16}),
          "2x16x16": AxisSizes({"pod": 2, "data": 16, "model": 16})}


def _ref_params(cfg):
    holder = {}

    def f(key):
        params, specs = ref_registry.init_params(key, cfg)
        holder["specs"] = specs
        return params

    return jax.eval_shape(f, jax.random.PRNGKey(0)), holder["specs"]


def _leaves(shapes_tree, specs_tree, prefix=""):
    """[(path, shape, axes)] of matching trees."""
    if isinstance(shapes_tree, dict):
        assert set(shapes_tree) == set(specs_tree), prefix
        return [leaf for k in sorted(shapes_tree) for leaf in _leaves(
            shapes_tree[k], specs_tree[k], f"{prefix}/{k}")]
    return [(prefix, tuple(shapes_tree.shape), tuple(specs_tree))]


def _config_pairs():
    for arch in ALL_ARCHS:
        yield arch, "smoke", ref_smoke(arch), get_smoke_config(arch)
        yield arch, "full", ref_config(arch), get_config(arch)


def _variants(ref_cfg, cfg):
    """The config plain, with the int8 cache and with the windowed one."""
    for flags in ({}, {"kv_quant": True}, {"windowed_cache": True}):
        yield (dataclasses.replace(ref_cfg, **flags),
               dataclasses.replace(cfg, **flags))


# -- sharding rules ---------------------------------------------------------------


@pytest.mark.parametrize("arch,size,ref_cfg,cfg", list(_config_pairs()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_spec_for_equals_the_references_for_every_leaf(arch, size, ref_cfg,
                                                       cfg):
    """Every param, cache and batch leaf, both production meshes, every
    policy, long-context overrides on the activations."""
    ref_shapes, ref_specs = _ref_params(ref_cfg)
    params, specs = registry.init_params(None, cfg, device="meta")
    param_leaves = _leaves(params, specs)
    assert param_leaves == _leaves(ref_shapes, ref_specs)
    act_leaves = []
    for rc, pc in _variants(ref_cfg, cfg):
        caches = registry.init_caches(pc, 4, 64, device="meta")
        act_leaves += _leaves(caches, registry.cache_specs(pc))
        ref_caches = jax.eval_shape(
            lambda: ref_registry.init_caches(rc, 4, 64))
        assert act_leaves[-len(_leaves(caches, registry.cache_specs(pc))):] \
            == _leaves(ref_caches, ref_registry.cache_specs(rc))
    for preset in shapes.SHAPES.values():
        if preset.kind != "decode":   # decode takes a token, not a batch
            act_leaves += _leaves(shapes.input_specs(cfg, preset),
                                  registry.batch_specs(
                                      cfg, preset.kind == "train"))
    n = 0
    for mesh in MESHES.values():
        for policy in part.POLICIES:
            prules, arules = part.apply_policy(policy)
            assert (prules, arules) == ref_part.apply_policy(policy)
            for _, dims, axes in param_leaves:
                got = part.spec_for(axes, mesh, dims, prules)
                assert got == tuple(ref_part.spec_for(axes, mesh, dims,
                                                      prules))
                n += 1
            for ov in (None, part.LONG_CONTEXT_OVERRIDES):
                for _, dims, axes in act_leaves:
                    got = part.spec_for(axes, mesh, dims, arules, ov)
                    assert got == tuple(ref_part.spec_for(
                        axes, mesh, dims, arules, ov))
                    n += 1
    assert n > 0


@settings(max_examples=50, deadline=None)
@given(dims=st.tuples(st.integers(1, 4096), st.integers(1, 4096),
                      st.integers(1, 64)),
       axes=st.tuples(*[st.sampled_from(
           [None, "batch", "embed", "ffn", "heads", "kv_heads", "vocab",
            "experts", "expert_ffn", "cache_seq", "head_dim", "seq"])] * 3),
       mesh=st.sampled_from(sorted(MESHES)),
       policy=st.sampled_from(sorted(part.POLICIES)))
def test_property_spec_for_equals_the_reference_on_random_dims(dims, axes,
                                                               mesh, policy):
    prules, arules = part.apply_policy(policy)
    for rules in (prules, arules):
        got = part.spec_for(axes, MESHES[mesh], dims, rules)
        assert got == tuple(ref_part.spec_for(axes, MESHES[mesh], dims,
                                              rules))
        sizes = part.mesh_axis_sizes(MESHES[mesh])
        for entry, dim in zip(got, dims):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            assert dim % int(np.prod([sizes[a] for a in names])) == 0


def test_rule_tables_are_the_references():
    assert part.PARAM_RULES == ref_part.PARAM_RULES
    assert part.ACT_RULES == ref_part.ACT_RULES
    assert part.AXIS_PRIORITY == ref_part.AXIS_PRIORITY
    assert part.POLICIES == ref_part.POLICIES
    assert part.LONG_CONTEXT_OVERRIDES == ref_part.LONG_CONTEXT_OVERRIDES


def test_active_act_rules_swaps_and_restores():
    _, arules = part.apply_policy("pure_dp")
    mesh = MESHES["16x16"]
    before = part.act_spec(("batch", "seq", "vocab"), mesh, (256, 8, 4096))
    with part.active_act_rules(arules):
        inside = part.act_spec(("batch", "seq", "vocab"), mesh,
                               (256, 8, 4096))
    assert before == ("data", None, "model")
    assert inside == (("data", "model"), None, None)
    assert part.act_spec(("batch", "seq", "vocab"), mesh,
                         (256, 8, 4096)) == before


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_mirror_init_caches(arch):
    """Plain, int8 and windowed: the spec tree has init_caches' keys and
    each spec one axis per dim."""
    for _, cfg in _variants(ref_smoke(arch), get_smoke_config(arch)):
        caches = registry.init_caches(cfg, 2, 64, device="meta")
        leaves = _leaves(caches, registry.cache_specs(cfg))
        assert leaves and all(len(d) == len(a) for _, d, a in leaves)


def test_helpers_stack_specs_spec_nbytes_and_long_context():
    assert stack_specs({"w": ("embed", "ffn"), "n": {"g": ("norm",)}}) == \
        {"w": ("layers", "embed", "ffn"), "n": {"g": ("layers", "norm")}}
    tree = {"a": torch.empty((4, 8), dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty((3,), dtype=torch.float32, device="meta")]}
    assert spec_nbytes(tree) == 4 * 8 * 2 + 3 * 4
    for arch in ALL_ARCHS:
        assert registry.supports_long_context(get_config(arch)) == \
            ref_registry.supports_long_context(ref_config(arch))
        for name, preset in shapes.SHAPES.items():
            assert shapes.applicable(get_config(arch), preset)[0] == (
                not preset.long_context
                or ref_config(arch).has_subquadratic_attention)
            assert dataclasses.astuple(preset) == \
                dataclasses.astuple(REF_SHAPES[name])


# -- constrain outside a mesh -------------------------------------------------------


def test_every_constrain_site_returns_its_input_outside_a_mesh(monkeypatch):
    """The 21 sites the reference has (attention 11, layers 4, moe 3,
    ssm 3), each reached by a plain CPU run, each handing back the very
    tensor it was given."""
    from repro_torch.models import attention, layers, moe, ssm
    seen = {}

    def spy(x, axes, *a, **k):
        frame = sys._getframe(1)
        out = part.constrain(x, axes, *a, **k)
        assert out is x
        seen[(Path(frame.f_code.co_filename).name, frame.f_lineno)] = axes
        return out

    for mod in (attention, layers, moe, ssm):
        monkeypatch.setattr(mod, "constrain", spy)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for arch, flags in [("qwen3-0.6b", {"attn_q_block": 32}),
                            ("gemma3-27b", {"windowed_cache": True}),
                            ("qwen3-0.6b", {"kv_quant": True}),
                            ("grok-1-314b", {}), ("mamba2-2.7b", {}),
                            ("whisper-medium", {})]:
            cfg = dataclasses.replace(get_smoke_config(arch), **flags)
            params, _ = registry.init_params(gen, cfg)
            batch = registry.make_dummy_batch(cfg, 2, 64)
            registry.forward(params, cfg, batch)
            caches = registry.init_caches(cfg, 2, 64)
            registry.prefill_encoder(params, cfg, batch, caches)
            registry.decode_step(params, cfg, batch["tokens"][:, :1], 3,
                                 caches)
    by_file = {}
    for name, _ in seen:
        by_file[name] = by_file.get(name, 0) + 1
    assert by_file == {"attention.py": 11, "layers.py": 4, "moe.py": 3,
                       "ssm.py": 3}


# -- op counts against the reference's HLO parser --------------------------------


def _ref_flops(fn, *args) -> float:
    return hlo_analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _batches(ref_cfg, cfg):
    rb = {"tokens": _sds((B, S), jnp.int32), "labels": _sds((B, S), jnp.int32)}
    pb = {k: torch.empty((B, S), dtype=torch.int64, device="meta")
          for k in ("tokens", "labels")}
    if cfg.family == "audio":
        rb["frames"] = _sds((B, cfg.enc_seq, cfg.d_model), jnp.bfloat16)
        pb["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                   dtype=torch.bfloat16, device="meta")
    if cfg.family == "vlm" and cfg.vision_tokens:
        rb["patches"] = _sds((B, cfg.vision_tokens, cfg.d_model),
                             jnp.bfloat16)
        pb["patches"] = torch.empty((B, cfg.vision_tokens, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta")
    return rb, pb


def _onehot(cfg, tokens: int) -> int:
    """The reference's one-hot embedding contraction (``embed_impl ==
    "onehot"``, ``layers.py:67-74``), 2 * tokens * vocab * d_model FLOPs;
    the port looks the rows up instead."""
    return (2 * tokens * padded_vocab(cfg) * cfg.d_model
            if cfg.embed_impl == "onehot" else 0)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_flops_equal_the_reference_hlo_count_less_the_onehot(arch):
    """Forward, prefill and one decode step of each smoke config: the
    port's dispatch count equals the reference's HLO count of its
    one-device CPU compile, less the one-hot embedding term, exactly."""
    rc, cfg = ref_smoke(arch), get_smoke_config(arch)
    ref_params, _ = _ref_params(rc)
    params, _ = registry.init_params(None, cfg, device="meta")
    rb, pb = _batches(rc, cfg)
    with torch.no_grad():
        fwd = op_count.analyze(
            lambda p, b: registry.forward(p, cfg, b).logits, params, pb)
        pre = op_count.analyze(
            lambda p, b: registry.prefill(p, cfg, b), params, pb)
        dec = op_count.analyze(
            lambda p, t, c: registry.decode_step(p, cfg, t, S - 1, c,
                                                 capacity_moe=True),
            params, torch.empty((B, 1), dtype=torch.int64, device="meta"),
            registry.init_caches(cfg, B, S, device="meta"))
    assert fwd["flops"] == _ref_flops(
        lambda p, b: ref_registry.forward(p, rc, b).logits, ref_params, rb
    ) - _onehot(cfg, B * S)
    assert pre["flops"] == _ref_flops(
        lambda p, b: ref_registry.prefill(p, rc, b), ref_params, rb
    ) - _onehot(cfg, B * S)
    ref_caches = jax.eval_shape(lambda: ref_registry.init_caches(rc, B, S))
    assert dec["flops"] == _ref_flops(
        lambda p, t, i, c: ref_registry.decode_step(p, rc, t, i, c),
        ref_params, _sds((B, 1), jnp.int32), _sds((), jnp.int32),
        ref_caches) - _onehot(cfg, B)
    assert dec["alias_bytes"] == op_count.local_nbytes(
        registry.init_caches(cfg, B, S, device="meta"))


def _early_stop_flops(cfg) -> int:
    """PyTorch's non-reentrant checkpoint stops recomputing a layer once
    the tensors its backward saved are back, so each layer's last
    projection (the MLP's ``w_down``, the Mamba2 mixer's ``out_proj``) is
    not rerun; the reference's ``jax.checkpoint`` reruns the whole layer:
    2 * tokens * fan_in * d_model a layer."""
    if cfg.family == "ssm":
        fan_in = cfg.ssm_expand * cfg.d_model
    else:
        fan_in = cfg.d_ff
    return 2 * B * S * fan_in * cfg.d_model * cfg.n_layers


def _ssd_transpose_flops(cfg) -> int:
    """Dots the reference's transposed chunk scan (``lax.scan`` over the
    SSD chunks) computes beyond autograd's backward of the port's Python
    loop over the chunks, found by comparing the two dot multisets over
    the stack: 10 contractions of 2*B*Q*H*P*N (state-sized cotangents,
    such as the first chunk's zero state, whose gradient autograd does not
    compute), 4 of 2*B*Q*Q*N (the C.B scores) and 8 of 2*B*Q*H*N, at the
    smoke config's chunk Q."""
    from repro_torch.models.ssm import ssm_dims
    _, h, p, n = ssm_dims(cfg)
    q = min(cfg.ssm_chunk, S)
    return (10 * 2 * B * q * h * p * n + 4 * 2 * B * q * q * n
            + 8 * 2 * B * q * h * n)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b"])
def test_train_step_flops_equal_the_reference_term_by_term(arch):
    """Two microbatches.  reference = port + the reference's microbatch
    remat (its scan body is ``jax.checkpoint``ed, so the backward reruns
    the whole loss forward once more, one-hot contraction included) + each
    layer's last projection that torch's checkpoint does not rerun (+ for
    mamba2 the chunk scan's transposed dots).  The compiled gradient holds
    no other one-hot dot: XLA keeps none for the first forward's
    embedding or its transpose, so beyond the rerun the port's row lookup
    costs what the reference's step does."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    rc, cfg = ref_smoke(arch), get_smoke_config(arch)
    ref_params, _ = _ref_params(rc)
    rb, pb = _batches(rc, cfg)
    f32 = jax.tree_util.tree_map(lambda s: _sds(s.shape, jnp.float32),
                                 ref_params)
    ref_state = {"params": ref_params,
                 "opt": {"m": f32, "v": f32, "step": _sds((), jnp.int32)}}
    ref = _ref_flops(ref_train_step(rc, RefAdamW(), n_microbatches=2),
                     ref_state, rb)
    ref_loss_fwd = _ref_flops(
        lambda p, b: ref_registry.loss_fn(p, rc, b)[0], ref_params, rb)

    def state():
        params, _ = registry.init_params(None, cfg, device="meta")
        params = tree_map(lambda p: p.requires_grad_(), params)
        return {"params": params, "opt": init_opt_state(params)}

    step = make_train_step(cfg, AdamWConfig(), n_microbatches=2)
    port = op_count.analyze(step, state(), pb)
    with set_checkpoint_early_stop(False):
        no_early_stop = op_count.analyze(step, state(), pb)["flops"]
    assert no_early_stop - port["flops"] == _early_stop_flops(cfg)
    ssd = _ssd_transpose_flops(cfg) if cfg.family == "ssm" else 0
    assert ref_loss_fwd == op_count.analyze(
        lambda p, b: registry.loss_fn(p, cfg, b)[0], state()["params"],
        pb)["flops"] + _onehot(cfg, B * S)
    assert ref == port["flops"] + ref_loss_fwd + _early_stop_flops(cfg) + ssd
    assert port["alias_bytes"] == port["argument_bytes"] - op_count.\
        local_nbytes(pb)


def test_op_count_peak_bytes_counts_each_storage_once_and_frees():
    mb = 1 << 20
    x = torch.empty(mb, dtype=torch.uint8, device="meta")

    def fn(x):
        a = x.float()               # 4 MiB
        b = a.view(-1)              # same storage: no new bytes
        c = b * 2                   # 4 MiB more: 9 MiB live with x
        del a, b
        d = c + 1                   # a's storage is gone: still 9 MiB
        return d.sum()              # + the 4-byte result

    got = op_count.analyze(fn, x)
    assert got["argument_bytes"] == mb
    assert got["peak_bytes"] == 9 * mb + 4
    assert scratch_bytes(got) == 8 * mb + 4
    assert got["flops"] == 0 and got["n_ops"] >= 4
    assert got["collectives"]["total"] == 0


def test_op_count_names_the_code_site_of_each_storage_at_the_peak():
    from repro_torch.models.layers import rmsnorm
    x = torch.empty((2, 3, 8), dtype=torch.bfloat16, device="meta")
    w = torch.empty((8,), dtype=torch.bfloat16, device="meta")
    plain = op_count.analyze(lambda a, b: rmsnorm(a, b), x, w)
    got = op_count.analyze(lambda a, b: rmsnorm(a, b), x, w, sites=True)
    assert "sites" not in plain and got["sites"] == {}
    assert {k: got[k] for k in plain} == plain
    assert got["largest"] == dict.fromkeys(op_count.COLLECTIVES, 0)
    assert sum(n for n, _ in got["peak_temps"]) == scratch_bytes(got)
    assert all(what.endswith("@ layers.py::rmsnorm")
               for _, what in got["peak_temps"])


# -- roofline arithmetic --------------------------------------------------------------


def test_roofline_and_hbm_bytes_match_the_reference_on_its_constants(
        monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW"):
        monkeypatch.setattr(analysis, name, getattr(ref_analysis, name))
    monkeypatch.setattr(analysis, "LINK_BW", ref_analysis.ICI_BW)
    cfg = get_config("qwen3-0.6b")
    for name, preset in shapes.SHAPES.items():
        kw = dict(params_bytes=1.2e9, opt_bytes=9.6e9, cache_bytes=3.7e9,
                  act_bytes=5.5e9)
        assert analysis.analytic_hbm_bytes(cfg, preset, 256, **kw) == \
            ref_analysis.analytic_hbm_bytes(cfg, REF_SHAPES[name], 256, **kw)
    args = ("qwen3-0.6b", "decode_32k", "16x16", 3.1e12, 2.2e9, 4.4e8,
            1.7e12)
    ours, ref = analysis.Roofline(*args), ref_analysis.Roofline(*args)
    assert (ours.compute_s, ours.memory_s, ours.collective_s, ours.dominant,
            ours.useful_flops_ratio, ours.row()) == (
        ref.compute_s, ref.memory_s, ref.collective_s, ref.dominant,
        ref.useful_flops_ratio, ref.row())
    assert analysis.ROOFLINE_HEADER == ref_analysis.ROOFLINE_HEADER


def test_h100_constants():
    assert (analysis.PEAK_FLOPS, analysis.PEAK_FLOPS_F32, analysis.HBM_BW,
            analysis.LINK_BW) == (989e12, 67e12, 3.35e12, 450e9)


# -- sharded dry runs on fake meshes, in subprocesses -------------------------------


FAKE_WORLD = """
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (init_fake_world, make_production_mesh,
                                     make_slice_mesh)
from repro_torch.launch.op_count import analyze
from repro_torch.launch.shapes import ShapePreset
from repro_torch.models import registry
from repro_torch.sharding.partitioning import (apply_policy, placements_for,
                                               spec_for)
out = {"sharded": {}, "shards": []}

# shard shapes on both production meshes against jax's NamedSharding
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    abstract = AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    for arch in ("qwen3-0.6b", "grok-1-314b", "llama4-maverick-400b-a17b"):
        params, specs = registry.init_params(None, get_config(arch),
                                             device="meta")
        caches = registry.init_caches(get_config(arch), 128, 1024,
                                      device="meta")
        cspecs = registry.cache_specs(get_config(arch))
        for policy in ("baseline", "expert_pod", "pure_dp"):
            prules, arules = apply_policy(policy)
            for tree, spec_tree, rules in ((params, specs, prules),
                                           (caches, cspecs, arules)):
                stack = [(tree, spec_tree)]
                while stack:
                    t, s = stack.pop()
                    if isinstance(t, dict):
                        stack += [(t[k], s[k]) for k in t]
                        continue
                    spec = spec_for(s, mesh, tuple(t.shape), rules)
                    local = distribute_tensor(
                        t, mesh, placements_for(spec, mesh)).to_local()
                    ref = NamedSharding(abstract, PartitionSpec(*spec)
                                        ).shard_shape(tuple(t.shape))
                    out["shards"].append([list(local.shape), list(ref)])

# a smoke config on 1x1 and 2x2 slices of the same world
cfg = get_smoke_config("qwen3-0.6b")
for kind, preset in [("decode", ShapePreset("d", "decode", 64, 4)),
                     ("prefill", ShapePreset("p", "prefill", 64, 4))]:
    one = dryrun.TRACE[kind](cfg, preset, make_slice_mesh([0], (1, 1)))
    four = dryrun.TRACE[kind](cfg, preset, make_slice_mesh(range(4), (2, 2)))
    params, _ = registry.init_params(None, cfg, device="meta")
    with torch.no_grad():
        if kind == "decode":
            plain = analyze(lambda p, t, c: registry.decode_step(
                p, cfg, t, 63, c, capacity_moe=True), params,
                torch.empty((4, 1), dtype=torch.int64, device="meta"),
                registry.init_caches(cfg, 4, 64, device="meta"))
        else:
            plain = analyze(lambda p, b: registry.prefill(p, cfg, b), params,
                            {"tokens": torch.empty((4, 64), dtype=torch.int64,
                                                   device="meta")})
    out["sharded"][kind] = [
        plain["flops"], one["flops"], four["flops"],
        one["collectives"]["total"], four["collectives"]["total"],
        plain["argument_bytes"], one["argument_bytes"],
        four["argument_bytes"]]
try:
    init_fake_world(8)
except RuntimeError as e:
    out["second_world"] = str(e)

# data.shard_batch: a DTensor per key, placed as asked
from torch.distributed.tensor import Replicate, Shard
from repro_torch.training.data import shard_batch
mesh = make_slice_mesh(range(4), (2, 2))
got = shard_batch({"tokens": torch.empty((8, 16), device="meta"),
                   "labels": torch.empty((8, 16), device="meta")}, mesh,
                  {"tokens": [Shard(0), Shard(1)],
                   "labels": [Shard(0), Replicate()]})
out["shard_batch"] = {k: list(v.to_local().shape) for k, v in got.items()}

# decode_32k on 16x16 where both batch and kv heads are sharded (the
# einsums of attention._sdpa, which torch 2.11's DTensor rule refuses)
out["decode_32k"] = {}
for arch in ("gemma3-27b", "zamba2-7b", "whisper-medium"):
    res = dryrun.run_combo(arch, "decode_32k")
    out["decode_32k"][arch] = {
        "ok": res.ok, "error": res.error, "flops": res.flops,
        "argument_bytes": res.argument_bytes,
        "temp_bytes": res.temp_bytes,
        "per_device_bytes": res.per_device_bytes,
        "collectives": {k: res.collectives[k] for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute")}}

# the CLI, as a user types it, with each collective's code site
dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
             "--out", sys.argv[1], "--sites"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    """One subprocess, one fake world of 512 ranks, for the tests below."""
    import json
    out_dir = tmp_path_factory.mktemp("dryrun")
    res = subprocess.run([sys.executable, "-c", FAKE_WORLD, str(out_dir)],
                         cwd=REPO,
                         env={"PYTHONPATH": f"{REPO / 'src'}",
                              "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                              "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    return json.loads(lines[-1]), lines[:-1], out_dir


def test_sharded_dry_run_on_fake_meshes(fake_world):
    got = fake_world[0]
    for kind in ("decode", "prefill"):
        plain, one, four, coll1, coll4, arg0, arg1, arg4 = \
            got["sharded"][kind]
        assert one == plain                       # 1x1: the unsharded count
        assert plain / 4 <= four <= plain
        assert coll1 == 0 and coll4 > 0
        assert arg1 == arg0 and arg0 / 4 <= arg4 < arg0
    assert "already up" in got["second_world"]
    assert got["shard_batch"] == {"tokens": [4, 8], "labels": [4, 16]}


def test_local_shards_equal_the_references_shard_shape(fake_world):
    """Both production meshes (("pod", "data") on one dim included), three
    policies, params and caches of a dense and both MoE configs."""
    pairs = fake_world[0]["shards"]
    assert len(pairs) == 276          # 46 leaves x 2 meshes x 3 policies
    for local, ref in pairs:
        assert local == ref


def test_dryrun_cli_decode_on_the_production_mesh(fake_world):
    import json
    _, printed, out_dir = fake_world
    row = [ln for ln in printed if ln.startswith("qwen3-0.6b")]
    assert len(row) == 1 and "16x16" in row[0]
    assert any("1 ok / 0 skipped / 0 FAILED" in ln for ln in printed)
    res = json.loads((out_dir / "dryrun.json").read_text())[0]
    assert res["ok"] and res["flops"] > 0 and res["argument_bytes"] > 0
    assert res["collectives"]["total"] > 0
    assert res["per_device_bytes"] == res["argument_bytes"] + \
        res["temp_bytes"]
    # --sites: every collective byte has its code site, the peak's
    # storages add up to the working set
    assert sum(res["sites"].values()) == res["collectives"]["total"]
    assert any(k.endswith("partitioning.py::lookup") for k in res["sites"])
    assert sum(n for n, _ in res["peak_temps"]) == res["temp_bytes"]
    assert sum(ln.startswith("      site  ") for ln in printed) == len(
        res["sites"])


#: per-device figures of decode_32k on the 16x16 mesh, where kv heads and
#: batch are both sharded, so each of attention._sdpa's einsums meets two
#: sharded batch dims (torch 2.11's DTensor refused to merge them).  Since
#: the einsums run shard by shard (sharding/partitioning.py::einsum):
#: gemma3-27b's figures are the ones the tree before that change gave, to
#: the byte; zamba2-7b's too but temp_bytes, 553,472 B lower (DTensor's
#: einsum held 16 int64 index chunks and a 256 KiB buffer at the peak);
#: whisper-medium's cross attention, whose q is partial over "data", now
#: reduce-scatters q to the batch shard of the cross K/V where DTensor's
#: rule gathered the cross K/V over the batch (before: 2,743,500,800 FLOPs,
#: temp 51,947,096 B, all-gather 1,188,318,208 B, all-reduce 19,611,648 B).
DECODE_32K_PINNED = {
    "gemma3-27b": {
        "flops": 43650646016.0, "argument_bytes": 8533872192,
        "temp_bytes": 352321536, "per_device_bytes": 8886193728,
        "collectives": {"all-gather": 25577472, "all-reduce": 10665984,
                        "reduce-scatter": 4198400, "all-to-all": 48513024,
                        "collective-permute": 0}},
    "zamba2-7b": {
        "flops": 12189442048.0, "argument_bytes": 3184232560,
        "temp_bytes": 122027008, "per_device_bytes": 3306259568,
        "collectives": {"all-gather": 324779008, "all-reduce": 308054560,
                        "reduce-scatter": 19455744, "all-to-all": 15518720,
                        "collective-permute": 0}},
    "whisper-medium": {
        "flops": 2190540800.0, "argument_bytes": 1696470592,
        "temp_bytes": 13303808, "per_device_bytes": 1709774400,
        "collectives": {"all-gather": 2378752, "all-reduce": 1179648,
                        "reduce-scatter": 346880, "all-to-all": 3987456,
                        "collective-permute": 0}},
}


@pytest.mark.parametrize("arch", list(DECODE_32K_PINNED))
def test_decode_32k_with_sharded_batch_and_kv_heads_is_pinned(fake_world,
                                                              arch):
    got = dict(fake_world[0]["decode_32k"][arch])
    assert got.pop("ok"), got["error"]
    got.pop("error")
    assert got == DECODE_32K_PINNED[arch]


def _sdpa_before(q, k, v, bias):
    """attention._sdpa's arithmetic as it was written with torch.einsum."""
    b_, sq, h, hd = q.shape
    kh = k.shape[2]
    q = q.unflatten(2, (kh, h // kh))
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    scores = scores / np.sqrt(hd)
    scores = scores + (bias[None, None, None] if bias.dim() == 2
                       else bias[:, :, None])
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(b_, sq, h, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1, 7])
def test_sdpa_on_plain_tensors_is_unchanged_bit_for_bit(dtype, sq):
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((2, sq, 6, 16), generator=gen).to(dtype)
    k, v = (torch.randn((2, 9, 2, 16), generator=gen).to(dtype)
            for _ in range(2))
    bias = torch.where(torch.rand((sq, 9), generator=gen) < 0.2,
                       attention.NEG_INF, 0.0)
    cfg = get_smoke_config("qwen3-0.6b")
    assert torch.equal(attention._sdpa(q, k, v, bias, cfg),
                       _sdpa_before(q, k, v, bias))


class _Mesh:
    def __init__(self, *sizes):
        self.sizes = sizes

    def size(self, i):
        return self.sizes[i]


class _DT:
    """What the local-einsum plan reads of a DTensor."""

    def __init__(self, shape, placements, mesh):
        self.shape, self.placements, self.device_mesh = \
            shape, placements, mesh


def test_einsum_local_plan_shards_only_batch_letters():
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _Mesh(16, 16)
    eq = "bqkgd,bskd->bkgqs"
    q = _DT((128, 1, 16, 2, 128), (Shard(0), Shard(2)), mesh)
    k = _DT((128, 32768, 16, 128), (Shard(0), Shard(2)), mesh)
    # both on batch letters: no redistribution
    assert part._batch_local_plan(eq, q, k) == (
        (Shard(0), Shard(2)), (Shard(0), Shard(2)), [Shard(0), Shard(1)])
    # a partial q is reduce-scattered to k's batch shard, a replicated
    # one sliced to it
    for p in (Partial(), Replicate()):
        qp = _DT(q.shape, (p, Shard(2)), mesh)
        assert part._batch_local_plan(eq, qp, k)[0] == (Shard(0), Shard(2))
    # k sharded on its context (not a batch letter), two different
    # letters, partial against replicated, an uneven split: DTensor's rule
    ks = _DT(k.shape, (Shard(0), Shard(1)), mesh)
    qr = _DT(q.shape, (Shard(0), Replicate()), mesh)
    assert part._batch_local_plan(eq, q, ks) is None
    assert part._batch_local_plan(eq, qr, ks) is None
    assert part._batch_local_plan(
        eq, _DT(q.shape, (Partial(), Shard(2)), mesh),
        _DT(k.shape, (Replicate(), Shard(2)), mesh)) is None
    assert part._batch_local_plan(
        eq, _DT((8, 1, 16, 2, 128), (Shard(0), Shard(2)), mesh),
        _DT((8, 32768, 16, 128), (Shard(0), Shard(2)), mesh)) is None
    # plain tensors never reach the plan
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    assert torch.equal(part.einsum("ij,jk->ik", a, b), a @ b)
