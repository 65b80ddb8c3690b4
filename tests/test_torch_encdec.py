"""The port's whisper encoder-decoder against the reference, on the CPU:
config, init, the attention parts (cross, bidirectional), encode, forward
(the reference's Pallas flash kernel in interpret mode on the "pallas"
path), the encoder prefill and the cache-filling decoder prefill against
the reference engine's ``prefill_encoder`` and prompt replay, decode, the
registry, the serving engine, the early restart, the loss and a train
step, the bridge at full whisper-medium width and the serve CLI.

Two configurations: the whisper smoke config (2 + 2 layers, GQA 4:2 at
head dim 64, 64 frames) and a small one at whisper's own head dim 64 in
its MHA layout, with 1024 frames, so that the encoder's attention takes
the q-blocked plain path (Sq a multiple of 512) unmasked.  The flash
kernel itself runs only on the card (tests/test_torch_cuda.py).

The reference's encoder scan keeps its carry in the frames' dtype, so on
f32 weights it takes f32 frames (bf16 frames into f32 weights are a type
error there: the first layer's output is f32).  The model-level tests
hold f32 weights with f32 frames; the engine, whose stub frames are bf16
zeros in both packages, is held on bf16 weights, the only ones the
reference's engine serves whisper on.

The random init is chaotic: it draws wq and wk at 1/sqrt(n_heads) with no
qk-norm, so attention scores run into the hundreds, and moving the frames
by one f32 step (one ulp) moves the reference's own f32 logits by more
than FORWARD_REL (test_unscaled_init_is_chaotic_and_the_port_within_it).
So the comparisons run on the same init with every attention's wq and wk
scaled by QK_SCALE, as tests/test_torch_training.py does for zamba2, which
brings the scores to O(1), as in a trained model; the one-ulp spread is
then below STEP_REL."""

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
from repro.core.mig_h100 import MigH100Backend as RefMigH100Backend
from repro.core.restart import NeedsLargerPartition as RefNeedsLargerPartition
from repro.models import attention as ref_attention
from repro.models import encdec as ref_encdec
from repro.models import registry as ref_registry
from repro.models.module import cast_tree as ref_cast_tree
from repro.serving import engine as ref_engine
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_train_step
from repro_torch.bridge import (caches_from_numpy, params_from_numpy,
                                state_from_numpy)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.restart import NeedsLargerPartition
from repro_torch.models import attention, encdec, registry
from repro_torch.models.module import cast_tree
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.training import optimizer
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train_step import make_train_step

ARCH = "whisper-medium"
REPO = Path(__file__).resolve().parents[1]
FORWARD_REL = 5e-3  # tests/test_sharding_and_layers.py:271
STEP_REL = 1e-4     # prefill / decode vs the replay: other sum orders
#: f32 loss and grad norm, port vs reference (tests/test_torch_training.py)
TRACE_REL = 1e-4
#: one bf16 step, relative to the value, at most (tests/test_torch_model.py)
BF16_STEP = 2.0 ** -7
#: an f32 attention part, port vs reference, relative to its largest
#: output: one chain of f32 products summed in other orders
#: (tests/test_torch_layers.py holds its f32 dots at 2e-5)
PART_REL = 1e-5

#: whisper-medium cut to a CPU size at its own head dim 64 and MHA layout;
#: 1024 frames put the encoder on the q-blocked path
D64 = dict(n_layers=2, enc_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
           head_dim=64, d_ff=256, vocab=512, enc_seq=1024, max_seq_len=1024)


def _configs(name):
    """(reference config, port config) of a test configuration."""
    if name == "smoke":
        return ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    return (dataclasses.replace(ref_get_config(ARCH), **D64),
            dataclasses.replace(get_config(ARCH), **D64))


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _impl(cfg, impl):
    return dataclasses.replace(cfg, attn_impl=impl)


#: every attention's wq and wk are scaled by this factor (module docstring)
QK_SCALE = 0.1


def _scale_qk(tree, scale=QK_SCALE):
    """A numpy param tree (params or a train state's) with wq and wk of the
    encoder, the decoder and the cross attention scaled, in their dtype."""
    for stack in ("encoder", "decoder", "cross"):
        for key in ("wq", "wk"):
            w = tree[stack][key]
            tree[stack][key] = (w.astype(np.float32) * np.float32(scale)
                                ).astype(w.dtype)
    return tree


def _ref_params(ref_cfg, dtype, scale=QK_SCALE, seed=0):
    """The reference's init, cast to ``dtype``, wq/wk scaled, as numpy."""
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return _scale_qk(jax.device_get(ref_cast_tree(ref_p, dtype)), scale)


def _pair(ref_cfg, cfg, ref_p):
    """(reference config, its params as jax arrays, port config, port
    params) of one numpy tree."""
    return (ref_cfg, jax.tree_util.tree_map(jnp.asarray, ref_p), cfg,
            params_from_numpy(ref_p, cfg))


@pytest.fixture(scope="module", params=["smoke", "d64"])
def weights(request):
    """f32 weights of a test configuration, wq/wk scaled, in both
    packages."""
    ref_cfg, cfg = _configs(request.param)
    return _pair(ref_cfg, cfg, _ref_params(ref_cfg, jnp.float32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _frames(cfg, b, seed):
    """Stub frames [B, enc_seq, d] in f32 (the dtype of the weights the
    model-level tests run), the same values on both sides."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("name", ["full", "smoke", "d64"])
def test_config_fields_and_values_match(name):
    if name == "full":
        ref, out = ref_get_config(ARCH), get_config(ARCH)
    else:
        ref, out = _configs(name)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)


def test_d64_config_is_whisper_mha_at_head_dim_64():
    _, cfg = _configs("d64")
    full = get_config(ARCH)
    assert cfg.resolved_head_dim == full.resolved_head_dim == 64
    assert cfg.kv_groups == full.kv_groups == 1
    # the reference's _attend q-blocks at 512 rows when Sq is a multiple
    assert cfg.enc_seq % 512 == 0 and cfg.enc_seq > 512


def test_init_params_keys_shapes_and_init_kinds(weights):
    ref_cfg, _, cfg, _ = weights
    ref_p, ref_specs = ref_registry.init_params(jax.random.PRNGKey(3),
                                                ref_cfg)
    gen = torch.Generator().manual_seed(3)
    p, specs = registry.init_params(gen, cfg)
    assert specs == jax.tree_util.tree_map(
        tuple, ref_specs, is_leaf=lambda x: isinstance(x, tuple))
    assert list(p) == list(ref_p)
    for stack in ("encoder", "decoder", "cross"):
        assert list(p[stack]) == list(ref_p[stack])
        for k, v in p[stack].items():
            ref = np.asarray(ref_p[stack][k].astype(jnp.float32))
            assert tuple(v.shape) == ref.shape and v.dtype == torch.bfloat16
            if "norm" in k:
                np.testing.assert_array_equal(v.float().numpy(), ref)
    for name in ("enc_pos", "dec_pos"):   # drawn at scale 0.02
        assert float(p[name].float().std()) == pytest.approx(0.02, rel=0.1)


# -- attention parts ----------------------------------------------------------


@pytest.mark.parametrize("part", ["bidirectional", "cross", "cross_kv"])
def test_attention_parts_match_reference(weights, part):
    """The encoder's self attention over all enc_seq frames (q-blocked and
    unmasked on the d64 config), cross attention of 40 decoder positions
    over them, and the encoder output's cross K/V, in f32."""
    ref_cfg, ref_p, cfg, p = weights
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    lp = {k: v[0] for k, v in p["encoder"].items()}
    ref_lp = {k: v[0] for k, v in ref_p["encoder"].items()}
    if part == "bidirectional":
        ref = ref_attention.mha_bidirectional(ref_lp, jnp.asarray(x),
                                              ref_cfg)
        out = attention.mha_bidirectional(lp, torch.from_numpy(x), cfg)
    elif part == "cross":
        xlp = {k: v[0] for k, v in p["cross"].items()}
        ref_xlp = {k: v[0] for k, v in ref_p["cross"].items()}
        y = rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
        ref = ref_attention.mha_cross(
            ref_xlp, jnp.asarray(y),
            *ref_attention.cross_kv(ref_xlp, jnp.asarray(x), ref_cfg),
            ref_cfg)
        out = attention.mha_cross(
            xlp, torch.from_numpy(y),
            *attention.cross_kv(xlp, torch.from_numpy(x), cfg), cfg)
    else:
        ref = jnp.stack(ref_attention.cross_kv(ref_lp, jnp.asarray(x),
                                               ref_cfg))
        out = torch.stack(attention.cross_kv(lp, torch.from_numpy(x), cfg))
    assert tuple(out.shape) == ref.shape
    assert _rel(out.numpy(), ref) < PART_REL


def test_audio_self_attention_skips_rope(weights):
    """whisper's decoder self attention has learned positions only: the
    port's mha_full equals the reference's, and differs from the same
    call with RoPE applied."""
    ref_cfg, ref_p, cfg, p = weights
    lp = {k: v[0] for k, v in p["decoder"].items()}
    ref_lp = {k: v[0] for k, v in ref_p["decoder"].items()}
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model),
                                                 dtype=np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    ref = ref_attention.mha_full(ref_lp, jnp.asarray(x), ref_cfg,
                                 jnp.asarray(pos))
    out = attention.mha_full(lp, torch.from_numpy(x), cfg,
                             torch.from_numpy(pos.copy()))
    assert _rel(out.numpy(), ref) < PART_REL
    roped = attention.mha_full(lp, torch.from_numpy(x),
                               dataclasses.replace(cfg, family="dense"),
                               torch.from_numpy(pos.copy()))
    assert _rel(roped.numpy(), ref) > 1e-2


# -- encode, forward ----------------------------------------------------------


def test_encode_matches_reference(weights):
    ref_cfg, ref_p, cfg, p = weights
    ref_f, f = _frames(cfg, 2, 6)
    ref = ref_encdec.encode(ref_p, ref_cfg, ref_f)
    out = encdec.encode(p, cfg, f)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert _rel(out.numpy(), ref) < FORWARD_REL


def test_zero_bf16_frames_into_f32_weights_promote(weights):
    """The engine's stub frames are bf16 zeros whatever the weights' dtype.
    On f32 weights the port's encoder promotes the bf16 stream in the
    first layer's projections and its residual add, as the reference's
    einsum and add do; the reference's scan then refuses the carry's change
    of dtype, so it is held against the reference's own layer functions
    looped in Python."""
    from repro.models.layers import mlp as ref_mlp
    from repro.models.layers import rmsnorm as ref_rmsnorm
    ref_cfg, ref_p, cfg, p = weights
    shape = (2, cfg.enc_seq, cfg.d_model)
    x = jnp.zeros(shape, jnp.bfloat16)
    x = x + ref_p["enc_pos"].astype(jnp.bfloat16)
    eps = ref_cfg.norm_eps
    for i in range(ref_cfg.enc_layers):
        lp = {k: v[i] for k, v in ref_p["encoder"].items()}
        x = x + ref_attention.mha_bidirectional(
            lp, ref_rmsnorm(x, lp["norm1"], eps), ref_cfg)
        x = x + ref_mlp(lp, ref_rmsnorm(x, lp["norm2"], eps), ref_cfg)
    ref = ref_rmsnorm(x, ref_p["enc_final_norm"], eps)
    assert ref.dtype == jnp.float32
    out = encdec.encode(p, cfg, torch.zeros(shape, dtype=torch.bfloat16))
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref) < PART_REL
    with pytest.raises(TypeError, match="carry"):
        ref_encdec.encode(ref_p, ref_cfg, jnp.zeros(shape, jnp.bfloat16))


def test_unscaled_init_is_chaotic_and_the_port_within_it():
    """On the unscaled f32 init (smoke config, 128 tokens), one f32 step
    up on every frame moves the reference's own forward logits by more
    than FORWARD_REL; the port's distance from the reference is no larger
    than that move, and on the init scaled by QK_SCALE the same move is
    below STEP_REL."""
    ref_cfg, cfg = _configs("smoke")
    tok = _tokens(cfg, 2, 128, 129)
    x = np.random.default_rng(128).standard_normal(
        (2, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    x_up = np.nextafter(x, np.float32(np.inf))
    fwd = jax.jit(lambda p, t, f: ref_encdec.forward(p, ref_cfg, t, f).logits)
    spread = {}
    for scale in (1.0, QK_SCALE):
        ref_cfg, ref_p, cfg, p = _pair(ref_cfg, cfg,
                                       _ref_params(ref_cfg, jnp.float32,
                                                   scale))
        ref_tok = jnp.asarray(tok, jnp.int32)
        ref = fwd(ref_p, ref_tok, jnp.asarray(x))
        spread[scale] = _rel(fwd(ref_p, ref_tok, jnp.asarray(x_up)), ref)
        if scale == 1.0:
            out = encdec.forward(p, cfg, torch.from_numpy(tok),
                                 torch.from_numpy(x)).logits
            assert _rel(out.numpy(), ref) <= spread[scale]
    assert spread[1.0] > FORWARD_REL and spread[QK_SCALE] < STEP_REL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq", [128, 40])
def test_forward_matches_reference(weights, impl, seq):
    ref_cfg, ref_p, cfg, p = weights
    tok = _tokens(cfg, 2, seq, seq + 1)
    ref_f, f = _frames(cfg, 2, seq)
    ref = ref_encdec.forward(ref_p, _impl(ref_cfg, impl),
                             jnp.asarray(tok, jnp.int32), ref_f).logits
    out = encdec.forward(p, _impl(cfg, impl), torch.from_numpy(tok),
                         f).logits
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < FORWARD_REL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_registry_forward_and_prefill_match_reference(weights, impl):
    ref_cfg, ref_p, cfg, p = weights
    tok = _tokens(cfg, 2, 64, 7)
    ref_f, f = _frames(cfg, 2, 7)
    ref = ref_registry.forward(ref_p, _impl(ref_cfg, impl),
                               {"tokens": jnp.asarray(tok, jnp.int32),
                                "frames": ref_f}).logits
    cfg = _impl(cfg, impl)
    batch = {"tokens": torch.from_numpy(tok), "frames": f}
    out = registry.forward(p, cfg, batch).logits
    assert _rel(out.numpy(), ref) < FORWARD_REL
    last = registry.prefill(p, cfg, batch)
    torch.testing.assert_close(last, out[:, -1:], rtol=1e-5, atol=1e-5)


def test_dummy_batch_frames_are_bf16_stub_embeddings():
    cfg = get_smoke_config(ARCH)
    a = registry.make_dummy_batch(cfg, 3, 16, seed=2)
    b = registry.make_dummy_batch(cfg, 3, 16, seed=2)
    assert a["frames"].shape == (3, cfg.enc_seq, cfg.d_model)
    assert a["frames"].dtype == torch.bfloat16
    assert torch.equal(a["frames"], b["frames"])
    assert "patches" not in a


# -- the encoder prefill, the decoder prefill and decode ----------------------


def _f32_caches(ref_caches, caches):
    return (jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                   ref_caches),
            cast_tree(caches, torch.float32))


def _ref_replay(ref_p, ref_cfg, tok, caches, start=0):
    step = jax.jit(lambda p, t, i, c: ref_registry.decode_step(
        p, ref_cfg, t, i, c))
    logits = []
    for j in range(tok.shape[1]):
        lg, caches = step(ref_p, jnp.asarray(tok[:, j:j + 1], jnp.int32),
                          jnp.int32(start + j), caches)
        logits.append(np.asarray(lg))
    return logits, caches


def _hold_caches(caches, ref_caches, cfg, rel=STEP_REL):
    want = caches_from_numpy(jax.device_get(ref_caches), cfg,
                             *caches["k"].shape[1:3])
    assert list(caches) == list(want) == ["k", "v", "cross_k", "cross_v"]
    for name, got in caches.items():
        assert got.dtype == want[name].dtype, name
        assert _rel(got.float().numpy(), want[name].float().numpy()) < rel, \
            name


#: prompt lengths of the replay comparisons (a longer one after the
#: shorter, as the hybrid's tests hold theirs)
REPLAY_LENS = [20, 2]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq", REPLAY_LENS)
def test_prefill_matches_reference_replay(weights, impl, seq):
    """registry.prefill_encoder then registry.prefill_caches (one forward
    that fills every decoder layer's self K/V and attends over the cached
    cross K/V) against the reference engine's prefill_encoder and prompt
    replay through decode_step, on f32 caches: the bf16 caches would round
    values on which the two sides agree to ~1e-6 one step apart at
    rounding boundaries, which hides the comparison."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = _impl(cfg, impl)
    tok = _tokens(cfg, 2, seq, seq)
    ref_f, f = _frames(cfg, 2, seq + 100)
    ref_caches, caches = _f32_caches(ref_registry.init_caches(ref_cfg, 2, 64),
                                     registry.init_caches(cfg, 2, 64))
    ref_caches = ref_registry.prefill_encoder(ref_p, ref_cfg,
                                              {"frames": ref_f}, ref_caches)
    ref_logits, ref_caches = _ref_replay(ref_p, ref_cfg, tok, ref_caches)
    caches = registry.prefill_encoder(p, cfg, {"frames": f}, caches)
    last, caches = registry.prefill_caches(p, cfg, torch.from_numpy(tok),
                                           caches)
    assert last.shape == (2, 1, ref_logits[-1].shape[-1])
    assert _rel(last.numpy(), ref_logits[-1]) < STEP_REL
    _hold_caches(caches, ref_caches, cfg)
    # nothing is written past the prompt
    assert not caches["k"][:, :, seq:].any()
    assert not caches["v"][:, :, seq:].any()


def test_bf16_cross_caches_hold_the_encoders_rounding(weights):
    """The model's own caches are bf16 whatever the params' dtype: each
    cross K/V entry within one bf16 step of the largest entry of the
    reference's."""
    ref_cfg, ref_p, cfg, p = weights
    ref_f, f = _frames(cfg, 2, 9)
    ref_caches = ref_registry.prefill_encoder(
        ref_p, ref_cfg, {"frames": ref_f},
        ref_registry.init_caches(ref_cfg, 2, 16))
    caches = registry.prefill_encoder(p, cfg, {"frames": f},
                                      registry.init_caches(cfg, 2, 16))
    want = caches_from_numpy(jax.device_get(ref_caches), cfg, 2, 16)
    for name in ("cross_k", "cross_v"):
        assert caches[name].dtype == torch.bfloat16
        ref = want[name].float().numpy()
        np.testing.assert_allclose(caches[name].float().numpy(), ref, rtol=0,
                                   atol=BF16_STEP * np.abs(ref).max())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_steps_after_prefill_match_reference(weights, impl):
    """A 12-token prefill, then four further greedy-fed decode steps, each
    step's logits and the final caches against the reference's replay of
    all 16 tokens, on f32 caches."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = _impl(cfg, impl)
    tok = _tokens(cfg, 2, 16, 11)
    ref_f, f = _frames(cfg, 2, 11)
    ref_caches, caches = _f32_caches(ref_registry.init_caches(ref_cfg, 2, 32),
                                     registry.init_caches(cfg, 2, 32))
    ref_caches = ref_registry.prefill_encoder(ref_p, ref_cfg,
                                              {"frames": ref_f}, ref_caches)
    ref_logits, ref_caches = _ref_replay(ref_p, ref_cfg, tok, ref_caches)
    caches = registry.prefill_encoder(p, cfg, {"frames": f}, caches)
    _, caches = registry.prefill_caches(p, cfg, torch.from_numpy(tok[:, :12]),
                                        caches)
    for pos in range(12, 16):
        lg, caches = registry.decode_step(
            p, cfg, torch.from_numpy(tok[:, pos:pos + 1]), pos, caches)
        assert _rel(lg.numpy(), ref_logits[pos]) < STEP_REL, pos
    _hold_caches(caches, ref_caches, cfg)


def test_decode_step_matches_reference(weights):
    """One step at position 5 from the same random caches (f32): the
    logits and every cache, the cross K/V left as they were."""
    ref_cfg, ref_p, cfg, p = weights
    rng = np.random.default_rng(8)
    ref_caches = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape, dtype=np.float32),
        jax.device_get(ref_registry.init_caches(ref_cfg, 2, 16)))
    tok = _tokens(cfg, 2, 1, 9)
    ref_lg, ref_new = jax.device_get(ref_registry.decode_step(
        ref_p, ref_cfg, jnp.asarray(tok, jnp.int32), jnp.int32(5),
        jax.tree_util.tree_map(jnp.array, ref_caches)))
    caches = caches_from_numpy(ref_caches, cfg, 2, 16)
    cross = caches["cross_k"].clone()
    lg, caches = registry.decode_step(p, cfg, torch.from_numpy(tok), 5,
                                      caches)
    assert _rel(lg.numpy(), ref_lg) < STEP_REL
    _hold_caches(caches, ref_new, cfg)
    assert torch.equal(caches["cross_k"], cross)


# -- serving ------------------------------------------------------------------

@pytest.fixture(scope="module", params=["smoke", "d64"])
def bf16_weights(request):
    """bf16 weights, wq/wk scaled, in both packages: the reference's engine
    serves whisper on bf16 weights only (its encoder scan takes the bf16
    zero frames' dtype).  Unscaled, the two bf16 engines part from the
    first tokens on, as two bf16 paths of either package do."""
    ref_cfg, cfg = _configs(request.param)
    return _pair(ref_cfg, cfg, _ref_params(ref_cfg, jnp.bfloat16))


def _pair_requests(prompts, max_new):
    return ([ref_engine.Request(uid=i, prompt=q, max_new_tokens=max_new)
             for i, q in enumerate(prompts)],
            [Request(uid=i, prompt=q, max_new_tokens=max_new)
             for i, q in enumerate(prompts)])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_tokens_and_series_match_reference(bf16_weights, impl):
    """Ragged prompts (padded with token 0 at the end, as both engines do),
    zero frames through the encoder first: identical greedy tokens and
    accountant series, which count the cross caches."""
    ref_cfg, ref_p, cfg, p = bf16_weights
    cfg = _impl(cfg, impl)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(2, 10))
                            ).astype(np.int32) for _ in range(3)]
    ref_reqs, reqs = _pair_requests(prompts, 10)
    ecfg = dict(max_batch=3, max_context=64, predict=False)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_p,
                                     ref_engine.EngineConfig(**ecfg))
    ref_out = ref_eng.run(ref_reqs)
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg), device="cpu")
    out = eng.run(reqs)
    assert [r.generated for r in out] == [r.generated for r in ref_out]
    assert all(len(r.generated) == 10 for r in out)
    for xs, ys in zip(eng.accountant.series(), ref_eng.accountant.series()):
        assert len(xs) == len(ys) == 11
        np.testing.assert_allclose(xs, ys, rtol=1e-6)


def test_early_restart_same_step_and_profile(bf16_weights):
    ref_cfg, ref_p, cfg, p = bf16_weights
    ecfg = dict(max_batch=1, max_context=96, partition_gb=1e-4, predict=True)
    prompt = np.arange(4, dtype=np.int32)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_p,
                                     ref_engine.EngineConfig(**ecfg),
                                     backend=RefMigH100Backend())
    with pytest.raises(RefNeedsLargerPartition) as ref_exc:
        ref_eng.run([ref_engine.Request(uid=0, prompt=prompt,
                                        max_new_tokens=80)])
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg),
                      backend=MigH100Backend(), device="cpu")
    with pytest.raises(NeedsLargerPartition) as exc:
        eng.run([Request(uid=0, prompt=prompt, max_new_tokens=80)])
    assert exc.value.profile.name == ref_exc.value.profile.name
    assert exc.value.profile.mem_gb == ref_exc.value.profile.mem_gb
    assert len(eng.accountant.history) == len(ref_eng.accountant.history)
    assert (eng.predictor.req_mem_list
            == pytest.approx(ref_eng.predictor.req_mem_list, rel=1e-6))


# -- training -----------------------------------------------------------------


def _ref_state(cfg, scale=QK_SCALE):
    state, _ = ref_train_step.init_train_state(jax.random.PRNGKey(0), cfg)
    state["params"] = ref_cast_tree(state["params"], jnp.float32)
    state = jax.device_get(state)
    _scale_qk(state["params"], scale)
    return state


def _data(ref_cfg, cfg, seed=0):
    """One SyntheticLM batch (B=2, S=32) of each package, the same bits
    (tests/test_torch_training.py holds the generators), with the bf16
    frames widened to f32 on both sides (exact) for the f32 weights."""
    from repro.training import data as ref_data
    ref = next(ref_data.SyntheticLM(ref_cfg, ref_data.DataConfig(2, 32, seed)
                                    ).batches())
    out = next(SyntheticLM(cfg, DataConfig(2, 32, seed)).batches())
    assert out["frames"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["frames"].view(torch.int16).numpy(),
                                  np.asarray(ref["frames"]).view(np.int16))
    ref["frames"] = ref["frames"].astype(jnp.float32)
    out["frames"] = out["frames"].float()
    return ref, out


def test_loss_fn_matches_reference():
    """The audio branch of registry.forward under loss_fn, on the unscaled
    f32 init: the mean over 64 positions holds where single logits do
    not."""
    ref_cfg, cfg = _configs("smoke")
    ref_p = _ref_state(ref_cfg, scale=1.0)["params"]
    ref_batch, batch = _data(ref_cfg, cfg)
    ref_loss, _ = ref_registry.loss_fn(jax.tree_util.tree_map(
        jnp.asarray, ref_p), ref_cfg, ref_batch)
    loss, out = registry.loss_fn(params_from_numpy(ref_p, cfg), cfg, batch)
    assert out.logits.shape == (2, 32, 512)
    assert abs(float(loss) - float(ref_loss)) <= TRACE_REL * float(ref_loss)


def test_train_step_matches_reference():
    """One make_train_step step (autograd through the checkpointed encoder
    and decoder layers at the default attn_impl "xla") against the
    reference's train_step from the same f32 state, wq/wk scaled: loss and
    grad norm.  Unscaled, the gradient norm is in the hundreds of
    thousands and moves with the sum order, as zamba2's does."""
    ref_cfg, cfg = _configs("smoke")
    ref_state = _ref_state(ref_cfg)
    ref_batch, batch = _data(ref_cfg, cfg)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    _, ref = jax.jit(ref_train_step.make_train_step(
        ref_cfg, ref_opt.AdamWConfig(**opt)))(
            jax.tree_util.tree_map(jnp.asarray, ref_state), ref_batch)
    # read before the port's step, which updates the numpy arrays it
    # shares with the reference's inputs in place
    ref = {k: float(v) for k, v in ref.items()}
    _, out = make_train_step(cfg, optimizer.AdamWConfig(**opt))(
        state_from_numpy(ref_state, cfg), batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(out[key]) - ref[key]) <= TRACE_REL * abs(ref[key]), \
            key
    assert float(out["grad_norm"]) > 0


# -- the bridge at full width, and the CLI ------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _same_leaves(port_tree, ref_tree):
    """Every key, shape and dtype of a port tree is the reference's."""
    got, want = dict(_leaves(port_tree)), dict(_leaves(ref_tree))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert str(got[key].dtype) == f"torch.{leaf.dtype.name}", key
    return want


def test_bridge_carries_full_width_params_and_caches():
    """At full whisper-medium width the port's tree, built on the meta
    device, is the reference's key for key, shape for shape and dtype for
    dtype (``jax.eval_shape`` allocates nothing), so the bridge takes the
    reference's full-width params and caches; a wrong shape is refused."""
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda k: ref_registry.init_params(k, ref_cfg)[0],
                            jax.random.PRNGKey(0))
    want = _same_leaves(registry.init_params(None, cfg, device="meta")[0],
                        shapes)
    assert sum(int(np.prod(v.shape)) for v in want.values()) == 994_400_256
    assert want["cross/wq"].shape == (24, 1024, 16, 64)
    assert want["embedding"].shape == (51968, 1024)
    assert want["enc_pos"].shape == (1500, 1024)
    assert want["dec_pos"].shape == (32768, 1024)
    cache_shapes = jax.eval_shape(
        lambda: ref_registry.init_caches(ref_cfg, 8, 448))
    caches = registry.init_caches(cfg, 8, 448, device="meta")
    _same_leaves(caches, cache_shapes)
    assert caches["k"].shape == (24, 8, 448, 16, 64)
    assert caches["cross_k"].shape == (24, 8, 1500, 16, 64)
    assert all(c.dtype == torch.bfloat16 for c in caches.values())
    smoke_ref, smoke = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    bad = jax.device_get(ref_registry.init_params(jax.random.PRNGKey(0),
                                                  smoke_ref)[0])
    bad["cross"]["wk"] = bad["cross"]["wk"][:, 1:]
    with pytest.raises(ValueError, match="cross/wk"):
        params_from_numpy(bad, smoke)


def test_serve_cli_runs_whisper_smoke_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "12",
         "--partition-gb", "0.0001"], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "family=audio" in res.stdout
    assert "EARLY RESTART" in res.stdout and "24 tokens" in res.stdout
