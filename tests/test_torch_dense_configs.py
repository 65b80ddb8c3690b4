"""The port's remaining dense and VLM configs against the reference, on the
CPU: qwen3-1.7b, gemma-2b (GeGLU, head dim 256, one KV head), gemma3-27b
(qk-norm, 5 local layers with a sliding window to 1 global) and pixtral-12b
(stub patch embeddings), and gemma-2b cut to a CPU size at its own head
dim 256 with one KV head.  For each: the config field for field, the layer
schedule, the forward at ``attn_impl`` "xla" and "pallas", the cache-filling
prefill against the reference engine's prompt replay, decode steps after
it, the serving engine's tokens, the bridge at full width and the serve
CLI; pixtral's forward and prefill with patches; and the reference's flash
kernel at head dim 256 with one KV head, in interpret mode, against the
port's wrapper.

All with reference weights cast to f32 and carried across by
``bridge.params_from_numpy``.  gemma3's smoke config has a window
of 64 and a global layer every 2: prompts of 100 tokens in a context of
128 cut the window in the prefill and in every decode step after it.  On
the CPU the "pallas" path runs the flash wrapper's plain version; the
kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.kernels.ops import flash_mha as ref_flash_mha
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models.module import cast_tree as ref_cast_tree
from repro.serving import engine as ref_engine
from repro_torch.bridge import caches_from_numpy, params_from_numpy
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.configs.base import reference_fields
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_mha
from repro_torch.models import layers, registry, transformer
from repro_torch.models.module import cast_tree
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

ARCHS = ["qwen3-1.7b", "gemma-2b", "gemma3-27b", "pixtral-12b"]
#: gemma-2b cut to a CPU size at its own head dim 256 with its one KV head
#: (the smoke config's head dim is d_model / n_heads = 64)
D256 = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1, head_dim=256,
            d_ff=512, vocab=512, max_seq_len=1024)
REPO = Path(__file__).resolve().parents[1]
FORWARD_REL = 5e-3  # tests/test_sharding_and_layers.py:271
#: prefill and decode vs the replay, f32 caches on both sides: the same
#: arithmetic in other sum orders (tests/test_torch_model.py)
STEP_REL = 1e-4
F32_TOL = 2e-5   # tests/test_kernels.py:37
BF16_TOL = 2e-2  # tests/test_kernels.py:52
#: prompt tokens and cache positions of the replay comparisons: beyond
#: gemma3's smoke window of 64
PROMPT, CONTEXT = 100, 128
DECODE_STEPS = 4


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _configs(name):
    """(reference config, port config) of a test configuration: an arch's
    smoke config, or "gemma-2b-d256"."""
    if name == "gemma-2b-d256":
        return (dataclasses.replace(ref_get_config("gemma-2b"), **D256),
                dataclasses.replace(get_config("gemma-2b"), **D256))
    return ref_get_smoke_config(name), get_smoke_config(name)


@pytest.fixture(scope="module", params=ARCHS + ["gemma-2b-d256"])
def weights(request):
    """Reference f32 weights of a test configuration and the same weights
    in the port."""
    ref_cfg, cfg = _configs(request.param)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    return ref_cfg, ref_p, cfg, params_from_numpy(jax.device_get(ref_p), cfg)


def test_d256_config_is_gemma_2b_mqa_at_head_dim_256():
    ref_cfg, cfg = _configs("gemma-2b-d256")
    assert reference_fields(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.resolved_head_dim == 256 and cfg.n_kv_heads == 1
    assert cfg.act == "geglu" and not cfg.qk_norm


# -- configs, schedule, layers ------------------------------------------------


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_values_match(arch, size):
    if size == "full":
        ref, out = ref_get_config(arch), get_config(arch)
    else:
        ref, out = ref_get_smoke_config(arch), get_smoke_config(arch)
    assert arch in ALL_ARCHS
    assert reference_fields(out) == dataclasses.asdict(ref)
    assert type(out).__module__ == "repro_torch.configs.base"


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_schedule_matches_reference(arch, size):
    """layer_pattern and the (window, chunk) each layer passes on, against
    the reference's layer_pattern: gemma3 runs 5 local layers to 1 global
    (62 = 10 x 6 + 2: 52 windowed layers at full size), the rest are all
    global."""
    get = get_config if size == "full" else get_smoke_config
    ref_get = ref_get_config if size == "full" else ref_get_smoke_config
    cfg, ref_cfg = get(arch), ref_get(arch)
    want = np.asarray(ref_transformer.layer_pattern(ref_cfg)).tolist()
    assert transformer.layer_pattern(cfg) == want
    masks = transformer._layer_masks(cfg)
    assert [w for w, _ in masks] == [
        None if win >= transformer.GLOBAL else win for win in want]
    assert all(chunk is None for _, chunk in masks)
    windowed = sum(w is not None for w, _ in masks)
    if arch != "gemma3-27b":
        assert windowed == 0
    elif size == "full":
        assert windowed == 52 and len(masks) == 62
        assert [i for i, (w, _) in enumerate(masks) if w is None] == list(
            range(5, 62, 6))
        assert {w for w, _ in masks} == {None, 1024}
    else:
        assert [w for w, _ in masks] == [64, None]


#: padded vocab of each vocab: 256,000, 262,144 and 131,072 are multiples
#: of 256 already; qwen3's 151,936 gains 128 pad columns
PADDED = {"qwen3-1.7b": 152_064, "gemma-2b": 256_000,
          "gemma3-27b": 262_144, "pixtral-12b": 131_072}


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_vocab_matches_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert layers.padded_vocab(cfg) == ref_layers.padded_vocab(ref_cfg)
    assert layers.padded_vocab(cfg) == PADDED[arch]


def test_geglu_and_embedding_scale_match_reference(weights):
    """The MLP (SwiGLU for qwen3 and pixtral, GeGLU for the gemmas) and
    the gemma-style sqrt(d) embedding scale, on the first layer's weights,
    f32 and bf16."""
    ref_cfg, ref_p, cfg, p = weights
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    tok = _tokens(cfg, 2, 7, 6)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2e-2)):
        lp = cast_tree({k: v[0] for k, v in p["layers"].items()}, dt)
        ref_lp = jax.tree_util.tree_map(lambda a: a[0].astype(jdt),
                                        ref_p["layers"])
        out = layers.mlp(lp, torch.from_numpy(x).to(dt), cfg)
        ref = ref_layers.mlp(ref_lp, jnp.asarray(x).astype(jdt), ref_cfg)
        assert _rel(out.float().numpy(), ref.astype(jnp.float32)) < tol
        emb = layers.embed_tokens(cast_tree(p, dt), torch.from_numpy(tok),
                                  cfg)
        ref_emb = ref_layers.embed_tokens(
            jax.tree_util.tree_map(lambda a: a.astype(jdt), ref_p),
            jnp.asarray(tok, jnp.int32), ref_cfg)
        np.testing.assert_array_equal(emb.float().numpy(),
                                      np.asarray(ref_emb, np.float32))


# -- forward, prefill, decode -------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq,q_block", [(PROMPT, 512), (128, 64)])
def test_forward_matches_reference(weights, impl, seq, q_block):
    """The port at attn_impl xla (plain; q-blocked at S=128 with blocks of
    64) and pallas (the flash adapter, S=100 ragged to its block) against
    the reference's forward (which takes XLA attention for every dense
    layer)."""
    ref_cfg, ref_p, cfg, p = weights
    ref_cfg = dataclasses.replace(ref_cfg, attn_q_block=q_block)
    cfg = dataclasses.replace(cfg, attn_impl=impl, attn_q_block=q_block)
    tok = _tokens(cfg, 2, seq, 7)
    ref = ref_registry.forward(ref_p, ref_cfg,
                               {"tokens": jnp.asarray(tok, jnp.int32)}).logits
    out = registry.forward(p, cfg, {"tokens": torch.from_numpy(tok)}).logits
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < FORWARD_REL


def _ref_replay(ref_p, ref_cfg, tok, caches):
    step = jax.jit(lambda p, t, i, c: ref_registry.decode_step(
        p, ref_cfg, t, i, c))
    logits = []
    for pos in range(tok.shape[1]):
        lg, caches = step(ref_p, jnp.asarray(tok[:, pos:pos + 1], jnp.int32),
                          jnp.int32(pos), caches)
        logits.append(np.asarray(lg))
    return logits, caches


def _f32_caches(ref_cfg, cfg, b):
    ref = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                 ref_registry.init_caches(ref_cfg, b,
                                                          CONTEXT))
    return ref, cast_tree(registry.init_caches(cfg, b, CONTEXT),
                          torch.float32)


def _check_caches(caches, ref_caches, cfg):
    want = caches_from_numpy(jax.device_get(ref_caches), cfg, 2, CONTEXT)
    for name in ("k", "v"):
        assert caches[name].dtype == want[name].dtype == torch.float32
        assert _rel(caches[name].numpy(), want[name].numpy()) < STEP_REL, \
            name


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference_replay(weights, impl):
    """registry.prefill_caches (one forward over a 100-token prompt that
    fills the K/V caches) against the reference engine's prompt replay
    through decode_step, then DECODE_STEPS further greedy decode steps on
    both sides; f32 caches, so logits and caches hold to STEP_REL.
    gemma3's local layers cut their window of 64 in both."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    tok = _tokens(cfg, 2, PROMPT, 11)
    ref_caches, caches = _f32_caches(ref_cfg, cfg, 2)
    ref_logits, ref_caches = _ref_replay(ref_p, ref_cfg, tok, ref_caches)
    last, caches = registry.prefill_caches(p, cfg, torch.from_numpy(tok),
                                           caches)
    assert last.shape == (2, 1, ref_logits[-1].shape[-1])
    assert _rel(last.numpy(), ref_logits[-1]) < STEP_REL
    _check_caches(caches, ref_caches, cfg)
    assert not caches["k"][:, :, PROMPT:].any()  # nothing past the prompt

    step = jax.jit(lambda p_, t, i, c: ref_registry.decode_step(
        p_, ref_cfg, t, i, c))
    nxt = np.asarray(ref_logits[-1][:, -1, :cfg.vocab].argmax(-1))[:, None]
    for i in range(DECODE_STEPS):
        pos = PROMPT + i
        ref_lg, ref_caches = step(ref_p, jnp.asarray(nxt, jnp.int32),
                                  jnp.int32(pos), ref_caches)
        lg, caches = registry.decode_step(p, cfg, torch.from_numpy(nxt), pos,
                                          caches)
        assert _rel(lg.numpy(), ref_lg) < STEP_REL, pos
        nxt = np.asarray(ref_lg)[:, -1, :cfg.vocab].argmax(-1)[:, None]
    _check_caches(caches, ref_caches, cfg)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_pixtral_forward_and_prefill_with_patches(impl):
    """The VLM route: 16 stub patch embeddings (bf16, as the reference's
    dummy batch makes them) override the first positions, through
    registry.forward and registry.prefill (the last position's logits)."""
    arch = "pixtral-12b"
    ref_cfg = ref_get_smoke_config(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl=impl)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(4), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    p = params_from_numpy(jax.device_get(ref_p), cfg)
    batch = registry.make_dummy_batch(cfg, 2, 40, seed=9)
    assert batch["patches"].shape == (2, 16, cfg.d_model)
    assert batch["patches"].dtype == torch.bfloat16
    ref = ref_registry.forward(ref_p, ref_cfg, {
        "tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32),
        "patches": jnp.asarray(batch["patches"].float().numpy()
                               ).astype(jnp.bfloat16)}).logits
    out = registry.forward(p, cfg, batch).logits
    assert _rel(out.numpy(), ref) < FORWARD_REL
    last = registry.prefill(p, cfg, batch)
    torch.testing.assert_close(last, out[:, -1:], rtol=1e-5, atol=1e-5)
    no_patches = registry.prefill(p, cfg, {"tokens": batch["tokens"]})
    assert not torch.allclose(no_patches, last)


def test_full_size_pixtral_dummy_batch_has_256_patches():
    cfg = get_config("pixtral-12b")
    batch = registry.make_dummy_batch(cfg, 1, 300, seed=0)
    assert batch["patches"].shape == (1, 256, 5120)
    assert batch["patches"].dtype == torch.bfloat16
    assert batch["tokens"].shape == (1, 300)


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_tokens_and_series_match_reference(weights, impl):
    """Ragged prompts of 60 to 100 tokens (padded with token 0, as both
    engines pad them) and 12 new tokens in a context of 128: identical
    greedy tokens and accountant series.  pixtral is served on text tokens
    alone, as the reference's engine serves it."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(60, PROMPT + 1))
                            ).astype(np.int32) for _ in range(3)]
    ref_reqs = [ref_engine.Request(uid=i, prompt=q, max_new_tokens=12)
                for i, q in enumerate(prompts)]
    reqs = [Request(uid=i, prompt=q, max_new_tokens=12)
            for i, q in enumerate(prompts)]
    ecfg = dict(max_batch=3, max_context=CONTEXT, predict=False)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_p,
                                     ref_engine.EngineConfig(**ecfg))
    ref_out = ref_eng.run(ref_reqs)
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg), device="cpu")
    out = eng.run(reqs)
    assert [r.generated for r in out] == [r.generated for r in ref_out]
    assert all(len(r.generated) == 12 for r in out)
    for xs, ys in zip(eng.accountant.series(), ref_eng.accountant.series()):
        assert len(xs) == len(ys) == 13
        np.testing.assert_allclose(xs, ys, rtol=1e-6)


# -- the flash kernel at head dim 256 -----------------------------------------


# (name, b, s, h, kh, dtype, window): gemma-2b's head dim with one KV head,
# causal as the model calls it; S=100 ragged to the block
D256_CASES = [
    ("f32-mqa", 2, 128, 8, 1, "f32", None),
    ("f32-mqa-ragged-s100", 1, 100, 4, 1, "f32", None),
    ("bf16-mqa", 2, 128, 8, 1, "bf16", None),
    ("bf16-mqa-window64", 1, 256, 8, 1, "bf16", 64),
    ("bf16-odd-group", 1, 128, 3, 1, "bf16", None),
]


@pytest.mark.parametrize("case", D256_CASES, ids=[c[0] for c in D256_CASES])
def test_flash_at_d256_mqa_matches_reference_kernel(case):
    """The reference's Pallas flash kernel in interpret mode (as
    tests/test_kernels.py runs it) against the port's adapter and its
    wrapper in the kernel layout, on the CPU (the wrapper's plain
    version); tolerances of the reference's kernel tests."""
    name, b, s, h, kh, dt, window = case
    rng = np.random.default_rng(len(name) + s)
    q, k, v = (rng.standard_normal((b, s, n, 256), dtype=np.float32)
               for n in (h, kh, kh))
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tol = F32_TOL if dt == "f32" else BF16_TOL
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    ref = np.asarray(ref_flash_mha(jq, jk, jv, causal=True, window=window,
                                   interpret=True).astype(jnp.float32))
    out = flash_mha(tq, tk, tv, causal=True, window=window)
    assert out.shape == (b, s, h, 256) and out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)
    if s % fa.BLOCK == 0:
        kern = fa.flash_attention(*(x.transpose(1, 2) for x in (tq, tk, tv)),
                                  causal=True, window=window)
        np.testing.assert_allclose(kern.transpose(1, 2).float().numpy(), ref,
                                   atol=tol, rtol=tol)
    assert fa.route(tdt, 256) == ("sm90" if dt == "bf16" else "simt")


# -- the bridge at full width, and the CLI ------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


#: params of the full configs (``jax.eval_shape`` of the reference's init)
FULL_PARAMS = {"qwen3-1.7b": 1_720_837_120, "gemma-2b": 2_506_172_416,
               "gemma3-27b": 27_008_335_616, "pixtral-12b": 11_576_693_760}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_full_width_params_and_caches(arch):
    """At full width the port's tree, built on the meta device, is the
    reference's key for key, shape for shape and dtype for dtype, so the
    bridge takes the reference's params (gemma-2b's single KV head,
    gemma3's qk-norm, pixtral's tree) and caches; a wrong shape is
    refused."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: ref_registry.init_params(k, ref_cfg)[0],
                            jax.random.PRNGKey(0))
    got = dict(_leaves(registry.init_params(None, cfg, device="meta")[0]))
    want = dict(_leaves(shapes))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert str(got[key].dtype) == f"torch.{leaf.dtype.name}", key
    assert sum(int(np.prod(v.shape)) for v in want.values()) \
        == FULL_PARAMS[arch]
    assert ("layers/q_norm" in got) == ("layers/k_norm" in got) \
        == cfg.qk_norm
    assert got["layers/wk"].shape[2] == cfg.n_kv_heads
    caches = registry.init_caches(cfg, 8, 2048, device="meta")
    ref_caches = jax.eval_shape(
        lambda: ref_registry.init_caches(ref_cfg, 8, 2048))
    for name in ("k", "v"):
        assert tuple(caches[name].shape) == tuple(ref_caches[name].shape) == (
            cfg.n_layers, 8, 2048, cfg.n_kv_heads, cfg.resolved_head_dim)
        assert caches[name].dtype == torch.bfloat16
    smoke_ref = ref_get_smoke_config(arch)
    bad = jax.device_get(ref_registry.init_params(jax.random.PRNGKey(0),
                                                  smoke_ref)[0])
    bad["layers"]["wk"] = bad["layers"]["wk"][:, :, :, 1:]
    with pytest.raises(ValueError, match="layers/wk"):
        params_from_numpy(bad, get_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_smoke_on_cpu(arch):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "2", "--prompt-len",
         "80", "--max-new", "12", "--max-context", "128"], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    family = get_config(arch).family
    assert f"family={family}" in res.stdout
    assert "24 tokens" in res.stdout
