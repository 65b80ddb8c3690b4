"""The port's decode cache variants against the reference, on the CPU: the
int8 KV cache (``kv_quant``: per-(token, head) int8 codes with f32 scales)
and the windowed ring cache (``windowed_cache``: the local layers of a
sliding-window config keep rings of W slots, the global layers a full
cache).  For each: the quantizer, the cache tree every config takes with
each flag, decode steps against the reference's ``decode_step``, the
cache-filling prefill against the reference engine's prompt replay, and
the serving engine's tokens and accountant series.

All on reference weights cast to f32 and carried across by
``bridge.params_from_numpy``; on the CPU the "pallas" path runs the flash
wrapper's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import attention as ref_attention
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models.module import cast_tree as ref_cast_tree
from repro.serving import engine as ref_engine
from repro_torch.bridge import caches_from_numpy, params_from_numpy
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core.memory.accountant import pytree_nbytes
from repro_torch.models import attention, registry, transformer
from repro_torch.models.module import cast_tree
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

FLAGS = {"none": {}, "kv_quant": {"kv_quant": True},
         "windowed_cache": {"windowed_cache": True},
         "both": {"kv_quant": True, "windowed_cache": True}}
#: logits and f32 caches vs the reference: the same arithmetic in other
#: sum orders (tests/test_torch_model.py)
STEP_REL = 1e-4
#: int8 decode vs the reference's int8 decode: the K/V the two packages
#: project differ by f32 sum orders (~1e-7), and where that moves x/scale
#: across a rounding boundary the code moves by one, a change of one scale
#: step (max|x|/127) in that element; a few such codes move the logits by
#: up to ~1e-4 of their largest, and the scales of the layers after them
#: by as much
INT8_STEP_REL = 1e-3
#: the codes' flips counted over a run: a flip is a tie broken by the last
#: bit of an f32 sum, so nearly all codes agree and none moves by more
#: than one
INT8_MAX_FLIP_SHARE = 1e-3


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _weights(ref_cfg, cfg, seed=0):
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(seed), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    return ref_p, params_from_numpy(jax.device_get(ref_p), cfg)


def _pair(name, **changes):
    """(reference config, port config) of an arch's smoke config with
    ``changes``."""
    return (dataclasses.replace(ref_get_smoke_config(name), **changes),
            dataclasses.replace(get_smoke_config(name), **changes))


def _f32(ref_caches, caches):
    """Both cache trees with every float leaf in f32 (int8 codes kept)."""
    ref = jax.tree_util.tree_map(
        lambda a: a if a.dtype == jnp.int8 else a.astype(jnp.float32),
        ref_caches)
    port = {k: v if v.dtype == torch.int8 else v.float()
            for k, v in caches.items()}
    return ref, port


def _check_caches(caches, ref_caches, cfg, b, context, rel=STEP_REL):
    """Each float leaf at ``rel``; int8 codes equal but for ties, none off
    by more than one."""
    want = caches_from_numpy(jax.device_get(ref_caches), cfg, b, context)
    assert caches.keys() == want.keys()
    for name, got in caches.items():
        assert got.dtype == want[name].dtype, name
        if got.dtype == torch.int8:
            diff = (got.int() - want[name].int()).abs()
            assert int(diff.max()) <= 1, name
            assert float((diff > 0).float().mean()) <= INT8_MAX_FLIP_SHARE
        else:
            assert _rel(got.numpy(), want[name].numpy()) < rel, name


# -- the quantizer --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_codes_and_scales_equal_the_reference(dtype):
    """Equal int8 codes and f32 scales on the same inputs (rows of zeros,
    of one value, and values that sit on a rounding tie included), and
    dequantize_kv equal in f32 and bf16."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32) * 4
    x[0, 0] = 0.0
    x[0, 1] = 2.5
    x[1, 2, 0] = np.arange(-8, 8) * 0.5 * 127 / 8   # max 63.5, x/scale ties
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x).astype(jdt)
    q, s = attention.quantize_kv(tx)
    rq, rs = ref_attention.quantize_kv(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert int(q.abs().max()) == 127
    for odt, ojdt in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        back = attention.dequantize_kv(q, s, odt)
        ref = ref_attention.dequantize_kv(rq, rs, ojdt)
        assert back.dtype == odt
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_quantize_kv_stays_within_half_a_scale_step():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 7, 2, 32)).astype(np.float32))
    q, s = attention.quantize_kv(x)
    err = (attention.dequantize_kv(q, s, torch.float32) - x).abs()
    assert bool((err <= s / 2 * (1 + 1e-6)).all())


# -- the cache trees -------------------------------------------------------------


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_tree_equals_the_reference(arch, flags, size):
    """Every config with every combination of the two flags takes the
    reference's cache tree, key for key, shape for shape and dtype for
    dtype: int8 wins over the rings, MoE configs keep the plain cache, a
    config without a sliding window and a global schedule keeps it with
    windowed_cache set, the ssm, hybrid and audio families read neither
    flag.  The full configs on the meta device."""
    get, ref_get = ((get_smoke_config, ref_get_smoke_config)
                    if size == "smoke" else (get_config, ref_get_config))
    b, context = (2, 16) if size == "smoke" else (8, 2048)
    cfg = dataclasses.replace(get(arch), **FLAGS[flags])
    ref_cfg = dataclasses.replace(ref_get(arch), **FLAGS[flags])
    device = "cpu" if size == "smoke" else "meta"
    got = dict(_leaves(registry.init_caches(cfg, b, context, device=device)))
    want = dict(_leaves(jax.eval_shape(
        lambda: ref_registry.init_caches(ref_cfg, b, context))))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert str(got[key].dtype) == f"torch.{leaf.dtype.name}", key
        if size == "smoke":
            assert not got[key].any(), key
    variant = ("int8" if "k_q" in got else "ring" if "local_k/" in
               "/".join(got) + "/" else "other")
    if cfg.family in ("dense", "vlm") and not cfg.n_experts:
        assert variant == ("int8" if cfg.kv_quant else "ring"
                           if cfg.windowed_cache and cfg.sliding_window
                           else "other")
    else:
        assert variant == "other"


def test_gemma3_full_cache_bytes():
    """gemma3-27b at B=8 in a context of 2048: the plain bf16 cache 7.75
    GiB, the windowed one 4.50 (52 rings of 1024 slots and 10 full global
    caches: 62 = 10 x 6 + 2), int8 3.875 with 0.121 of f32 scales."""
    gib = {}
    for name, flags in FLAGS.items():
        cfg = dataclasses.replace(get_config("gemma3-27b"), **flags)
        caches = registry.init_caches(cfg, 8, 2048, device="meta")
        gib[name] = pytree_nbytes(caches) / 2**30
    assert gib == {"none": 7.75, "kv_quant": 3.99609375,
                   "windowed_cache": 4.5, "both": 3.99609375}
    cfg = get_config("gemma3-27b")
    assert transformer.windowed_layout(cfg) == \
        ref_transformer.windowed_layout(ref_get_config("gemma3-27b")) \
        == (10, 6, 2)


# -- decode -------------------------------------------------------------------


def _ref_step(ref_cfg):
    return jax.jit(lambda p, t, i, c: ref_registry.decode_step(
        p, ref_cfg, t, i, c))


@pytest.mark.parametrize("window", [4, 8])
def test_ring_decode_past_its_wrap_matches_reference(window):
    """gemma3's smoke config with windowed_cache, a window of 4 or 8 and 5
    layers (2 groups of a local and a global layer, then a local tail):
    3W decode steps from position 0, so every ring wraps twice, against
    the reference's decode_step, caches in f32 on both sides; and against
    the port's plain cache with the window as a mask, which must attend
    over the same positions."""
    ref_cfg, cfg = _pair("gemma3-27b", windowed_cache=True,
                         sliding_window=window, n_layers=5)
    ref_p, p = _weights(ref_cfg, cfg)
    context, s = 4 * window, 3 * window
    ref_caches, caches = _f32(ref_registry.init_caches(ref_cfg, 2, context),
                              registry.init_caches(cfg, 2, context))
    assert set(caches) == {"local_k", "local_v", "global_k", "global_v",
                           "tail_k", "tail_v"}
    assert caches["local_k"].shape == (2, 1, 2, window, 2, 64)
    plain_cfg = dataclasses.replace(cfg, windowed_cache=False)
    plain = cast_tree(registry.init_caches(plain_cfg, 2, context),
                      torch.float32)
    tok = _tokens(cfg.vocab, 2, s, 5)
    step = _ref_step(ref_cfg)
    for pos in range(s):
        t = tok[:, pos:pos + 1]
        ref_lg, ref_caches = step(ref_p, jnp.asarray(t, jnp.int32),
                                  jnp.int32(pos), ref_caches)
        lg, caches = registry.decode_step(p, cfg, torch.from_numpy(t), pos,
                                          caches)
        assert _rel(lg.numpy(), ref_lg) < STEP_REL, pos
        plain_lg, plain = registry.decode_step(p, plain_cfg,
                                               torch.from_numpy(t), pos,
                                               plain)
        assert _rel(lg.numpy(), plain_lg.numpy()) < STEP_REL, pos
    _check_caches(caches, ref_caches, cfg, 2, context)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b"])
def test_int8_decode_matches_reference(arch):
    """12 int8 decode steps (gemma3's smoke window of 64 cut at 40
    positions in) against the reference's decode_step on f32 weights, the
    codes equal but for ties (INT8_STEP_REL says why); and the int8 logits
    against the plain f32 cache's within the reference's own 0.02
    (tests/test_sharding_and_layers.py:222-240)."""
    changes = {"sliding_window": 8} if arch == "gemma3-27b" else {}
    ref_cfg, cfg = _pair(arch, kv_quant=True, **changes)
    ref_p, p = _weights(ref_cfg, cfg)
    ref_caches = ref_registry.init_caches(ref_cfg, 2, 16)
    caches = registry.init_caches(cfg, 2, 16)
    plain_cfg = dataclasses.replace(cfg, kv_quant=False)
    plain = cast_tree(registry.init_caches(plain_cfg, 2, 16), torch.float32)
    tok = _tokens(cfg.vocab, 2, 12, 7)
    step = _ref_step(ref_cfg)
    for pos in range(12):
        t = tok[:, pos:pos + 1]
        ref_lg, ref_caches = step(ref_p, jnp.asarray(t, jnp.int32),
                                  jnp.int32(pos), ref_caches)
        lg, caches = registry.decode_step(p, cfg, torch.from_numpy(t), pos,
                                          caches)
        assert _rel(lg.numpy(), ref_lg) < INT8_STEP_REL, pos
        plain_lg, plain = registry.decode_step(p, plain_cfg,
                                               torch.from_numpy(t), pos,
                                               plain)
        assert _rel(lg.numpy(), plain_lg.numpy()) < 0.02, pos
    _check_caches(caches, ref_caches, cfg, 2, 16, INT8_STEP_REL)


# -- the prefill ----------------------------------------------------------------


#: prompt tokens and cache positions of the prefill comparisons: beyond
#: gemma3's smoke window of 64, so the rings hold the last 64 of 100
PROMPT, CONTEXT = 100, 128
VARIANTS = [("gemma3-27b", "windowed_cache"), ("gemma3-27b", "kv_quant"),
            ("qwen3-0.6b", "kv_quant")]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch,flag", VARIANTS)
def test_prefill_fills_the_variant_as_the_reference_replay(arch, flag, impl):
    """registry.prefill_caches (one forward over a 100-token prompt) into a
    ring or int8 cache against the reference engine's prompt replay
    through decode_step into the same cache: the last logits and every
    cache leaf (the rings of gemma3's local layer hold positions 36..99 in
    slots p mod 64, its global layer all 100 positions), then 4 decode
    steps on both sides.  Rings and global caches in f32 on both sides, so
    they hold to STEP_REL; the int8 codes equal but for ties."""
    ref_cfg, cfg = _pair(arch, **FLAGS[flag])
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    ref_p, p = _weights(ref_cfg, cfg)
    ref_caches, caches = _f32(
        ref_registry.init_caches(ref_cfg, 2, CONTEXT),
        registry.init_caches(cfg, 2, CONTEXT))
    tol = INT8_STEP_REL if flag == "kv_quant" else STEP_REL
    tok = _tokens(cfg.vocab, 2, PROMPT, 11)
    step = _ref_step(ref_cfg)
    for pos in range(PROMPT):
        ref_lg, ref_caches = step(ref_p, jnp.asarray(tok[:, pos:pos + 1],
                                                     jnp.int32),
                                  jnp.int32(pos), ref_caches)
    last, caches = registry.prefill_caches(p, cfg, torch.from_numpy(tok),
                                           caches)
    assert _rel(last.numpy(), ref_lg) < tol
    _check_caches(caches, ref_caches, cfg, 2, CONTEXT, tol)
    if flag == "windowed_cache":
        assert caches["local_k"].shape[3] == 64
        # slot p mod 64 holds position p for p in 36..99: the plain
        # prefill's K at those positions
        plain_cfg = dataclasses.replace(cfg, windowed_cache=False)
        plain = cast_tree(registry.init_caches(plain_cfg, 2, CONTEXT),
                          torch.float32)
        registry.prefill_caches(p, plain_cfg, torch.from_numpy(tok), plain)
        pos = torch.arange(PROMPT - 64, PROMPT)
        torch.testing.assert_close(caches["local_k"][0, 0][:, pos % 64],
                                   plain["k"][0][:, pos], rtol=0, atol=0)
        torch.testing.assert_close(caches["global_v"][0], plain["v"][1],
                                   rtol=0, atol=0)
    else:
        assert not caches["k_q"][:, :, PROMPT:].any()
    nxt = np.asarray(ref_lg)[:, -1, :cfg.vocab].argmax(-1)[:, None]
    for i in range(4):
        pos = PROMPT + i
        ref_lg, ref_caches = step(ref_p, jnp.asarray(nxt, jnp.int32),
                                  jnp.int32(pos), ref_caches)
        lg, caches = registry.decode_step(p, cfg, torch.from_numpy(nxt), pos,
                                          caches)
        assert _rel(lg.numpy(), ref_lg) < tol, pos
        nxt = np.asarray(ref_lg)[:, -1, :cfg.vocab].argmax(-1)[:, None]
    _check_caches(caches, ref_caches, cfg, 2, CONTEXT, tol)


# -- serving ------------------------------------------------------------------


#: (arch, flag, config changes): gemma3's smoke config with a window of 16
#: that the prompts of 20 to 40 tokens and 24 new tokens wrap; qwen3 int8
ENGINE_CASES = [("gemma3-27b", "windowed_cache", {"sliding_window": 16}),
                ("qwen3-0.6b", "kv_quant", {}),
                ("gemma3-27b", "kv_quant", {"sliding_window": 16})]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch,flag,changes", ENGINE_CASES,
                         ids=[f"{a}-{f}" for a, f, _ in ENGINE_CASES])
def test_engine_with_each_flag_matches_reference(arch, flag, changes, impl):
    """ServeEngine.run with each flag, bf16 rings and int8 caches as the
    engines make them: identical greedy tokens and accountant series at
    rel 1e-6 (the live bytes count the variant's smaller cache)."""
    ref_cfg, cfg = _pair(arch, **FLAGS[flag], **changes)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    ref_p, p = _weights(ref_cfg, cfg, seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(20, 41))
                            ).astype(np.int32) for _ in range(3)]
    ecfg = dict(max_batch=3, max_context=72, predict=False)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_p,
                                     ref_engine.EngineConfig(**ecfg))
    ref_out = ref_eng.run([ref_engine.Request(uid=i, prompt=q,
                                              max_new_tokens=24)
                           for i, q in enumerate(prompts)])
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg), device="cpu")
    out = eng.run([Request(uid=i, prompt=q, max_new_tokens=24)
                   for i, q in enumerate(prompts)])
    assert [r.generated for r in out] == [r.generated for r in ref_out]
    assert all(len(r.generated) == 24 for r in out)
    for xs, ys in zip(eng.accountant.series(), ref_eng.accountant.series()):
        assert len(xs) == len(ys) == 25
        np.testing.assert_allclose(xs, ys, rtol=1e-6)
    plain = ServeEngine(dataclasses.replace(cfg, kv_quant=False,
                                            windowed_cache=False),
                        p, EngineConfig(**ecfg), device="cpu")
    plain.run([Request(uid=i, prompt=q, max_new_tokens=24)
               for i, q in enumerate(prompts)])
    assert eng.accountant.peak_in_use < plain.accountant.peak_in_use
