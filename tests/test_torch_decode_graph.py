"""The decode step with its position as a device tensor, on the CPU: what
a captured decode graph (``serving/decode_graph.py``) needs of it.

* ``registry.decode_step`` at a 0-dim int64 tensor ``index`` equals the
  ``int`` call bit for bit, logits and every cache leaf, for every smoke
  config and cache kind (plain; int8; a ring past its wrap; llama4's
  chunked layers across a chunk boundary; ssm; hybrid; audio);
* the same steps match the reference's jitted ``decode_step`` at a traced
  ``jnp.int32(pos)`` on exported weights, at the tolerances of
  ``tests/test_torch_{engine,cache_variants,moe}.py``;
* the tensor-index step reads no device value on the host: run on ``meta``
  tensors (standing for the card's) under a dispatch mode that raises on
  every op that would read a device value on the host or copy host data
  to the device, which is what a CUDA graph capture refuses; MoE layers
  on the capacity dispatch pass, the dropless ``moe_tokens`` does not;
* the engine keeps its decode step per shape and the regrow loop builds a
  new one per slice.  The graph itself runs only on the card
  (``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import registry as ref_registry
from repro.models.module import cast_tree as ref_cast_tree
from repro_torch.bridge import caches_from_numpy, params_from_numpy
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.module import cast_tree, tree_leaves
from repro_torch.serving import decode_graph, engine as engine_mod
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

#: logits and f32 caches vs the reference (tests/test_torch_model.py)
STEP_REL = 1e-4
#: int8 decode vs the reference's (tests/test_torch_cache_variants.py)
INT8_STEP_REL = 1e-3
B = 2

#: (id, arch, config changes, context, first position, steps)
CASES = [(arch, arch, {}, 24, 0, 8) for arch in ALL_ARCHS
         if arch != "llama4-maverick-400b-a17b"] + [
    # the chunk of 64 cut between positions 63 and 64
    ("llama4-maverick-400b-a17b-chunk-boundary",
     "llama4-maverick-400b-a17b", {}, 72, 58, 10),
    ("qwen3-0.6b-int8", "qwen3-0.6b", {"kv_quant": True}, 24, 0, 8),
    ("gemma3-27b-int8", "gemma3-27b", {"kv_quant": True,
                                       "sliding_window": 4}, 24, 0, 10),
    # a ring of 4 slots wrapped twice and a half
    ("gemma3-27b-ring", "gemma3-27b", {"windowed_cache": True,
                                       "sliding_window": 4}, 24, 0, 10),
]
IDS = [c[0] for c in CASES]


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _tokens(vocab, steps, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (B, steps))


def _at(pos: int) -> torch.Tensor:
    return torch.tensor(pos, dtype=torch.int64)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tensor_index_equals_the_int_bit_for_bit(case):
    _, arch, changes, context, first, steps = case
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    params, _ = registry.init_params(torch.Generator().manual_seed(0), cfg)
    by_int = registry.init_caches(cfg, B, context)
    by_tensor = registry.init_caches(cfg, B, context)
    tok = torch.from_numpy(_tokens(cfg.vocab, steps))
    with torch.inference_mode():
        for i in range(steps):
            t, pos = tok[:, i:i + 1], first + i
            a, _ = registry.decode_step(params, cfg, t, pos, by_int,
                                        capacity_moe=True)
            b, _ = registry.decode_step(params, cfg, t, _at(pos), by_tensor,
                                        capacity_moe=True)
            assert torch.equal(a, b), pos
    for x, y in zip(tree_leaves(by_int), tree_leaves(by_tensor)):
        assert torch.equal(x, y)
    assert any(leaf.any() for leaf in tree_leaves(by_tensor))


def _f32_caches(ref_caches, caches):
    """Both cache trees with every float leaf in f32 (int8 codes kept)."""
    ref = jax.tree_util.tree_map(
        lambda a: a if a.dtype == jnp.int8 else a.astype(jnp.float32),
        ref_caches)
    return ref, cast_tree(caches, torch.float32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tensor_index_matches_the_reference_jitted_decode(case):
    """Each step's logits within STEP_REL of the reference's jitted
    decode_step at a traced position (INT8_STEP_REL for int8 caches, whose
    codes may move by one at a rounding tie), and the caches after the
    last step: float leaves within the step tolerance, int8 codes within
    one."""
    _, arch, changes, context, first, steps = case
    ref_cfg = dataclasses.replace(ref_get_smoke_config(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    p = params_from_numpy(jax.device_get(ref_p), cfg)
    ref_caches, caches = _f32_caches(
        ref_registry.init_caches(ref_cfg, B, context),
        registry.init_caches(cfg, B, context))
    step = jax.jit(lambda p_, t, i, c: ref_registry.decode_step(
        p_, ref_cfg, t, i, c))
    tol = INT8_STEP_REL if cfg.kv_quant else STEP_REL
    tok = _tokens(cfg.vocab, steps)
    with torch.inference_mode():
        for i in range(steps):
            t, pos = tok[:, i:i + 1], first + i
            ref_lg, ref_caches = step(ref_p, jnp.asarray(t, jnp.int32),
                                      jnp.int32(pos), ref_caches)
            lg, caches = registry.decode_step(p, cfg, torch.from_numpy(t),
                                              _at(pos), caches,
                                              capacity_moe=True)
            assert _rel(lg.numpy(), ref_lg) < tol, pos
    want = caches_from_numpy(jax.device_get(ref_caches), cfg, B, context)
    got = dict(zip(_paths(caches), tree_leaves(caches)))
    for name, ref in zip(_paths(want), tree_leaves(want)):
        if ref.dtype == torch.int8:
            assert int((got[name].int() - ref.int()).abs().max()) <= 1, name
        else:
            assert _rel(got[name].numpy(), ref.float().numpy()) < tol, name


def _paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += (_paths(v, f"{prefix}{k}/") if isinstance(v, dict)
                else [prefix + k])
    return out


# -- what a capture refuses ----------------------------------------------


#: ops that read a device tensor's values on the host (a sync a capture
#: refuses) or whose output shape depends on them
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "bincount",
              "unique", "_unique", "_unique2", "unique_consecutive",
              "unique_dim", "repeat_interleave", "equal", "is_nonzero"}


class HostRead(RuntimeError):
    pass


class RefuseHostReads(TorchDispatchMode):
    """Raise on any op of HOST_READS that touches a tensor off the CPU,
    and on any op that mixes host tensors (other than 0-dim scalars, which
    torch passes by value) with device tensors: a copy between the two.
    Off the card, ``meta`` tensors stand for the card's."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def tensors(tree):
            return [t for t in tree_flatten(tree)[0]
                    if isinstance(t, torch.Tensor)]

        def check(ts):
            if not any(t.device.type != "cpu" for t in ts):
                return
            if func._overloadpacket.__name__ in HOST_READS:
                raise HostRead(f"{func} reads a device value on the host")
            if any(t.device.type == "cpu" and t.dim() > 0 for t in ts):
                raise HostRead(f"{func} moves data between host and device")

        check(tensors((args, kwargs)))
        out = func(*args, **kwargs)
        check(tensors((args, kwargs, out)))
        return out


def _meta_step(cfg, capacity_moe, context=24):
    params, _ = registry.init_params(None, cfg, device="meta")
    caches = registry.init_caches(cfg, B, context, device="meta")
    tok = torch.empty((B, 1), dtype=torch.int64, device="meta")
    index = torch.empty((), dtype=torch.int64, device="meta")
    with torch.inference_mode(), RefuseHostReads():
        logits, _ = registry.decode_step(params, cfg, tok, index, caches,
                                         capacity_moe=capacity_moe)
    return logits


SYNC_CASES = [(arch, {}) for arch in ALL_ARCHS] + [
    ("qwen3-0.6b", {"kv_quant": True}), ("gemma3-27b", {"kv_quant": True}),
    ("gemma3-27b", {"windowed_cache": True, "sliding_window": 4})]


@pytest.mark.parametrize("arch,changes", SYNC_CASES,
                         ids=[a + "".join(f"-{k}" for k in c)
                              for a, c in SYNC_CASES])
def test_tensor_index_step_reads_no_device_value_on_the_host(arch, changes):
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    logits = _meta_step(cfg, capacity_moe=True)
    assert logits.shape[:2] == (B, 1) and logits.device.type == "meta"


@pytest.mark.parametrize("arch", ["grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_dropless_moe_decode_reads_the_expert_counts_on_the_host(arch):
    """moe_tokens' per-expert counts come to the host, which a capture
    refuses; so the graph decodes MoE through the capacity dispatch."""
    with pytest.raises(HostRead, match="bincount"):
        _meta_step(get_smoke_config(arch), capacity_moe=False)


def test_the_mode_catches_a_host_read_and_a_host_copy():
    x = torch.ones(3, device="meta")
    with pytest.raises(HostRead, match="host"), RefuseHostReads():
        torch.nonzero(x)
    with pytest.raises(HostRead, match="between host and device"), \
            RefuseHostReads():
        x.copy_(torch.ones(3))
    with RefuseHostReads():                   # a host scalar is a value
        x + torch.tensor(2.0)


# -- the engine's decode step ---------------------------------------------


def test_decode_graph_refuses_the_cpu():
    cfg = get_smoke_config("qwen3-0.6b")
    params, _ = registry.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="on the card"):
        decode_graph.DecodeGraph(params, cfg, B, 16, "cpu")
    eager = decode_graph.decoder_for(params, cfg, B, 16, torch.device("cpu"))
    assert type(eager) is decode_graph.EagerDecode


def _requests(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(4, 9))).astype(np.int32),
        max_new_tokens=10) for i in range(n)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "grok-1-314b"])
def test_engine_keeps_one_decode_step_per_shape(arch):
    """A second run of the same batch reuses the decode step, its caches
    zeroed, and gives the first run's tokens and series; a new batch gets
    a decode step of its own."""
    cfg = get_smoke_config(arch)
    params, _ = registry.init_params(torch.Generator().manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=3, max_context=32,
                                                predict=False), device="cpu")
    first = [r.generated for r in eng.run(_requests(cfg, 3))]
    series = eng.accountant.series()
    step = eng.decoders[(3, 32)]
    again = [r.generated for r in eng.run(_requests(cfg, 3))]
    assert eng.decoders[(3, 32)] is step and again == first
    for xs, ys in zip(eng.accountant.series(), series):
        np.testing.assert_array_equal(xs, ys)
    eng.run(_requests(cfg, 2))
    assert set(eng.decoders) == {(3, 32), (2, 32)}


def test_the_regrow_loop_builds_a_decode_step_per_slice(monkeypatch):
    """launch/serve.py's regrow loop: a new engine per slice, so a new
    decode step (on the card a new capture) per slice."""
    cfg = get_smoke_config("qwen3-0.6b")
    params, _ = registry.init_params(torch.Generator().manual_seed(0), cfg)
    built = []

    def counting(*args):
        built.append(decode_graph.decoder_for(*args))
        return built[-1]

    monkeypatch.setattr(engine_mod, "decoder_for", counting)
    reqs = serve_mod.make_requests(cfg, 2, 6, 12, seed=0)
    engine, out, restarts = serve_mod.serve(
        cfg, params, reqs, max_context=64, partition_gb=1e-4,
        backend=MigH100Backend(), device="cpu", log=lambda line: None)
    assert len(restarts) == 1 and len(built) == 2
    assert built[0] is not built[1]
    assert engine.decoders[(2, 64)] is built[1]
    assert all(len(r.generated) == 12 for r in out)
