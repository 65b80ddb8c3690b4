"""The port's MoE family against the reference, on the CPU: grok-1-314b (a
top-2 MoE FFN over 8 experts in every layer, GQA 6:1) and
llama4-maverick-400b-a17b (top-1 over 128 experts every second layer,
dense layers between, chunked local attention with one global layer in
four), on their f32 smoke configs (4 experts, 2 layers; llama4's chunk 64)
with reference weights carried across by ``bridge.params_from_numpy``.

Held: the configs field for field; ``moe_layer`` (capacity dispatch,
slot-major queues, dropped tokens, the aux loss) and ``moe_tokens`` (each
token a group of one, expert by expert); the forward's logits and aux
loss; the cache-filling prefill and decode against the reference engine's
prompt replay, on 80-token prompts so that llama4's smoke chunk of 64
cuts the prefill and every decode step; the serving engine; the loss and
one AdamW step; the bridge at full width; the serve CLI; and
``ParamBuilder``'s slice-by-slice draw of a tensor whose slices are
themselves over ``DRAW_LIMIT``."""

import dataclasses
import gc
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models.module import cast_tree as ref_cast_tree
from repro.serving import engine as ref_engine
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_train_step
from repro_torch.bridge import (caches_from_numpy, params_from_numpy,
                                state_from_numpy)
from repro_torch.configs import (ALL_ARCHS, ONE_CARD_LAYERS, get_config,
                                 get_smoke_config)
from repro_torch.configs.base import reference_fields
from repro_torch.models import module, moe, registry, transformer
from repro_torch.models.module import (ParamBuilder, cast_tree, tree_leaves,
                                       tree_map)
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.training import optimizer
from repro_torch.training.train_step import make_train_step

ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
REPO = Path(__file__).resolve().parents[1]
FORWARD_REL = 5e-3  # tests/test_sharding_and_layers.py:271
#: prefill and decode vs the replay, f32 caches on both sides: the same
#: arithmetic in other sum orders (tests/test_torch_model.py)
STEP_REL = 1e-4
#: one MoE layer in f32, port vs reference: the same products in other
#: sum orders
MOE_REL = 1e-5
#: the gradient comparisons scale every wq and wk by this factor: without
#: qk-norm the random init's scores are ~60 at the smoke width, where a
#: change of sum order alone moves the gradient norm by over 1e-4, as for
#: zamba2 (tests/test_torch_training.py::ZAMBA2_QK_SCALE)
QK_SCALE = 0.1
#: prompt tokens and cache positions of the replay comparisons: beyond
#: llama4's smoke chunk of 64
PROMPT, CONTEXT = 80, 128
DECODE_STEPS = 4


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """Reference f32 weights of an arch's smoke config and the same weights
    in the port."""
    ref_cfg, cfg = (ref_get_smoke_config(request.param),
                    get_smoke_config(request.param))
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    return ref_cfg, ref_p, cfg, params_from_numpy(jax.device_get(ref_p), cfg)


def _moe_params(p, ref_p, cfg, i=0):
    """The i-th MoE layer's params in both packages."""
    stack = "layers" if cfg.moe_every == 1 else "moe_layers"
    return ({k: v[i] for k, v in p[stack].items()},
            jax.tree_util.tree_map(lambda a: a[i], ref_p[stack]))


def _skewed_x(lp, cfg, b, s, seed, push=10.0):
    """Random [b, s, d] activations pushed toward expert 0's router column,
    so that most first choices go to expert 0 and its queue overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    col = lp["router"][:, 0].numpy()
    return x + push * col / np.linalg.norm(col)


def _dropped(experts, cap, slot_major=True):
    """Which tokens lose at least one of their top-k slots to capacity, for
    routes ``experts`` [B, G, T, k]: each expert's queue, per group, takes
    every first choice before any second choice (``slot_major``) or each
    token's choices in turn."""
    b_, g, t, k = experts.shape
    out = np.zeros((b_, g, t), bool)
    for bi in range(b_):
        for gi in range(g):
            used = {}
            order = ([(tok, sl) for sl in range(k) for tok in range(t)]
                     if slot_major else
                     [(tok, sl) for tok in range(t) for sl in range(k)])
            for tok, sl in order:
                e = experts[bi, gi, tok, sl]
                if used.get(e, 0) >= cap:
                    out[bi, gi, tok] = True
                else:
                    used[e] = used.get(e, 0) + 1
    return out


def _changed(lp, x, cfg, out):
    """Tokens whose moe_layer output ``out`` is not the dropless one
    (moe_tokens), beyond the sum order (MOE_REL of the largest entry)."""
    dropless = moe.moe_tokens(lp, torch.from_numpy(x), cfg)
    diff = (dropless - out).abs().amax(-1)
    return (diff > MOE_REL * float(dropless.abs().max())).numpy()


# -- configs ------------------------------------------------------------------


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
    """Each layer's attention mask against the reference's layer_pattern
    and its FFN: grok's layers are all global and all MoE; llama4's layer
    i is MoE iff i is odd and global iff (i+1) % 4 == 0 (the smoke config:
    every second layer), its other layers chunked."""
    get = get_config if size == "full" else get_smoke_config
    ref_get = ref_get_config if size == "full" else ref_get_smoke_config
    cfg, ref_cfg = get(arch), ref_get(arch)
    want = np.asarray(ref_transformer.layer_pattern(ref_cfg)).tolist()
    assert transformer.layer_pattern(cfg) == want
    masks = transformer._layer_masks(cfg)
    params, _ = registry.init_params(None, cfg, device="meta")
    ffns = transformer.layer_ffns(transformer.layer_views(params["layers"]),
                                  params, cfg)
    kinds = [is_moe for is_moe, _ in ffns]
    if arch == "grok-1-314b":
        assert masks == [(None, None)] * cfg.n_layers
        assert all(kinds)
        return
    chunk = cfg.attention_chunk
    ge = cfg.global_every
    assert masks == [(None, None) if (i + 1) % ge == 0 else (None, chunk)
                     for i in range(cfg.n_layers)]
    assert kinds == [i % 2 == 1 for i in range(cfg.n_layers)]
    ffn_shapes = [tuple(fp["w_down"].shape) for _, fp in ffns]
    assert ffn_shapes[0] == (2 * cfg.d_ff, cfg.d_model)
    assert ffn_shapes[1] == (cfg.n_experts, cfg.d_ff, cfg.d_model)


#: params of the configs cut to ONE_CARD_LAYERS: grok's 6 layers and
#: llama4's 4 (2 dense at d_ff 16,384, 2 MoE of 128 experts)
ONE_CARD_PARAMS = {"grok-1-314b": 30_325_192_704,
                   "llama4-maverick-400b-a17b": 34_004_055_040}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_card_cut_keeps_widths_and_fits_the_card(arch):
    """The depth the card serves each MoE config at (chip_smoke.py's phase
    4f, profile_serve): only n_layers changes, the bf16 weights fit an 80
    GB card with room for the init's f32 slice, llama4 keeps its
    dense/MoE interleave and one global layer, and the cut tree is the
    reference's at that depth."""
    full = get_config(arch)
    cut = dataclasses.replace(full, n_layers=ONE_CARD_LAYERS[arch])
    assert set(ONE_CARD_LAYERS) == set(ARCHS)
    assert cut.n_layers < full.n_layers
    params, _ = registry.init_params(None, cut, device="meta")
    n = sum(t.numel() for t in tree_leaves(params))
    assert n == ONE_CARD_PARAMS[arch]
    assert 2 * n < 70 * 2**30
    ffns = transformer.layer_ffns(transformer.layer_views(params["layers"]),
                                  params, cut)
    masks = transformer._layer_masks(cut)
    if arch == "grok-1-314b":
        assert all(is_moe for is_moe, _ in ffns)
        assert masks == [(None, None)] * cut.n_layers
    else:
        assert [is_moe for is_moe, _ in ffns] == [False, True, False, True]
        assert [chunk is None for _, chunk in masks] == [False] * 3 + [True]
    ref_cut = dataclasses.replace(ref_get_config(arch),
                                  n_layers=ONE_CARD_LAYERS[arch])
    shapes = jax.eval_shape(lambda k: ref_registry.init_params(k, ref_cut)[0],
                            jax.random.PRNGKey(0))
    assert dict((k, tuple(v.shape)) for k, v in _leaves(params)) == \
        dict((k, tuple(v.shape)) for k, v in _leaves(shapes))


# -- the MoE layer ------------------------------------------------------------


@pytest.mark.parametrize("push", [0.0, 10.0], ids=["random", "skewed"])
def test_moe_layer_matches_reference(weights, push):
    """moe_layer's output and aux loss in f32 against the reference's, with
    the routes equal, on 2 x 96 tokens (one group of 96 a sequence); the
    skewed input overflows expert 0's queue, so capacity drops tokens."""
    ref_cfg, ref_p, cfg, p = weights
    lp, ref_lp = _moe_params(p, ref_p, cfg)
    x = _skewed_x(lp, cfg, 2, 96, 3, push)
    out, aux = moe.moe_layer(lp, torch.from_numpy(x), cfg)
    ref_out, ref_aux = ref_moe.moe_layer(ref_lp, jnp.asarray(x), ref_cfg)
    assert out.shape == (2, 96, cfg.d_model)
    assert _rel(out.numpy(), ref_out) < MOE_REL
    assert abs(float(aux) - float(ref_aux)) <= MOE_REL * abs(float(ref_aux))
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", jnp.asarray(x),
                                      ref_lp["router"]), axis=-1)
    _, ref_idx = jax.lax.top_k(probs, cfg.top_k)
    _, idx = moe.top_k_routes(lp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    cap = moe.capacity(cfg, moe.group_size(96))
    drops = _dropped(idx.numpy()[:, None], cap)[:, 0]
    np.testing.assert_array_equal(_changed(lp, x, cfg, out), drops)
    if push:
        assert drops.sum() > 0


def test_capacity_queues_are_slot_major():
    """grok's top-2 at a capacity that binds: every first choice of a group
    is queued before any second choice.  On this input the token-major
    order would drop other tokens; the port drops exactly the slot-major
    ones, and matches the reference."""
    ref_cfg = dataclasses.replace(ref_get_smoke_config("grok-1-314b"),
                                  capacity_factor=0.5)
    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"),
                              capacity_factor=0.5)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(1), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    p = params_from_numpy(jax.device_get(ref_p), cfg)
    lp, ref_lp = _moe_params(p, ref_p, cfg)
    x = _skewed_x(lp, cfg, 1, 64, 5, push=1.0)
    out, _ = moe.moe_layer(lp, torch.from_numpy(x), cfg)
    ref_out, _ = ref_moe.moe_layer(ref_lp, jnp.asarray(x), ref_cfg)
    assert _rel(out.numpy(), ref_out) < MOE_REL
    _, idx = moe.top_k_routes(lp, torch.from_numpy(x), cfg)
    cap = moe.capacity(cfg, 64)
    slot_major = _dropped(idx.numpy()[:, None], cap)[:, 0]
    token_major = _dropped(idx.numpy()[:, None], cap, slot_major=False)[:, 0]
    assert (slot_major != token_major).any()
    np.testing.assert_array_equal(_changed(lp, x, cfg, out), slot_major)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_tokens_is_moe_layer_at_s1(weights, dtype):
    """moe_tokens over 2 x 50 tokens against moe_layer with every token its
    own group ([100, 1, d]), in the port and in the reference: nothing is
    dropped at S=1.  In f32 within MOE_REL of the reference; in bf16 the
    port's two functions take the same products and sums."""
    ref_cfg, ref_p, cfg, p = weights
    lp, ref_lp = _moe_params(p, ref_p, cfg)
    x = _skewed_x(lp, cfg, 2, 50, 7)
    if dtype == "f32":
        got = moe.moe_tokens(lp, torch.from_numpy(x), cfg)
        ref, _ = ref_moe.moe_layer(
            ref_lp, jnp.asarray(x).reshape(100, 1, -1), ref_cfg)
        assert got.shape == x.shape
        assert _rel(got.numpy().reshape(100, 1, -1), ref) < MOE_REL
        at_s1, _ = moe.moe_layer(lp, torch.from_numpy(x).reshape(100, 1, -1),
                                 cfg)
        assert _rel(got.numpy(), at_s1.reshape(got.shape).numpy()) < MOE_REL
        return
    lp = cast_tree(lp, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    got = moe.moe_tokens(lp, xb, cfg)
    at_s1, _ = moe.moe_layer(lp, xb.reshape(100, 1, -1), cfg)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, at_s1.reshape(got.shape), rtol=2e-2,
                               atol=2e-2 * float(at_s1.abs().max()))
    ref, _ = ref_moe.moe_layer(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref_lp),
        jnp.asarray(x).astype(jnp.bfloat16).reshape(100, 1, -1), ref_cfg)
    assert _rel(got.float().numpy().reshape(100, 1, -1),
                ref.astype(jnp.float32)) < 2e-2


def test_moe_ffn_is_silu_under_grok_geglu():
    """grok's act="geglu" does not reach the experts: moe_layer gates them
    with SiLU whatever cfg.act says, as the reference does; a GELU gate
    would give other numbers.  Against the FFN written out token by token
    at a capacity factor of E / k, where nothing is dropped."""
    ref_cfg, cfg = (ref_get_smoke_config("grok-1-314b"),
                    get_smoke_config("grok-1-314b"))
    assert cfg.act == ref_cfg.act == "geglu"
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(2), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    p = params_from_numpy(jax.device_get(ref_p), cfg)
    lp, ref_lp = _moe_params(p, ref_p, cfg)
    x = torch.from_numpy(_skewed_x(lp, cfg, 1, 32, 8, push=0.0))
    out, _ = moe.moe_layer(lp, x, cfg)
    silu, _ = moe.moe_layer(lp, x, dataclasses.replace(cfg, act="swiglu"))
    torch.testing.assert_close(out, silu, rtol=0, atol=0)
    ref, _ = ref_moe.moe_layer(ref_lp, jnp.asarray(x.numpy()), ref_cfg)
    assert _rel(out.numpy(), ref) < MOE_REL
    dropless = dataclasses.replace(cfg, capacity_factor=2.0)
    out, _ = moe.moe_layer(lp, x, dropless)
    gates, experts = moe.top_k_routes(lp, x, cfg)
    want = torch.zeros_like(x)
    gelu = torch.zeros_like(x)
    for slot in range(cfg.top_k):
        for t in range(x.shape[1]):
            e = int(experts[0, t, slot])
            xt = x[0, t]
            g = xt @ lp["w_gate"][e]
            u = xt @ lp["w_up"][e]
            w = gates[0, t, slot]
            want[0, t] += w * ((torch.nn.functional.silu(g) * u)
                               @ lp["w_down"][e])
            gelu[0, t] += w * ((torch.nn.functional.gelu(
                g, approximate="tanh") * u) @ lp["w_down"][e])
    assert _rel(out.numpy(), want.numpy()) < MOE_REL
    assert _rel(gelu.numpy(), want.numpy()) > 1e-2


# -- forward, prefill, decode -------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_reference(weights, impl):
    """Logits and the summed aux loss of the MoE layers against the
    reference's forward (which takes XLA attention for every layer; the
    port's pallas path sends grok's layers and llama4's global layer to the
    flash adapter, its chunked layers stay plain)."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    tok = _tokens(cfg, 2, 128, 7)
    ref = ref_registry.forward(ref_p, ref_cfg,
                               {"tokens": jnp.asarray(tok, jnp.int32)})
    out = registry.forward(p, cfg, {"tokens": torch.from_numpy(tok)})
    assert out.logits.shape == ref.logits.shape
    assert _rel(out.logits.numpy(), ref.logits) < FORWARD_REL
    assert float(out.aux_loss) > 0
    assert abs(float(out.aux_loss) - float(ref.aux_loss)) \
        <= FORWARD_REL * float(ref.aux_loss)


def _ref_replay(ref_p, ref_cfg, tok, caches):
    step = jax.jit(lambda p, t, i, c: ref_registry.decode_step(
        p, ref_cfg, t, i, c))
    logits = []
    for pos in range(tok.shape[1]):
        lg, caches = step(ref_p, jnp.asarray(tok[:, pos:pos + 1], jnp.int32),
                          jnp.int32(pos), caches)
        logits.append(np.asarray(lg))
    return logits, caches, step


def _check_caches(caches, ref_caches, cfg):
    want = caches_from_numpy(jax.device_get(ref_caches), cfg, 2, CONTEXT)
    for name in ("k", "v"):
        assert caches[name].dtype == want[name].dtype == torch.float32
        assert _rel(caches[name].numpy(), want[name].numpy()) < STEP_REL, \
            name


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference_replay(weights, impl):
    """registry.prefill_caches over an 80-token prompt against the
    reference engine's replay through decode_step (every MoE call a token
    alone), then DECODE_STEPS greedy decode steps on both sides; f32
    caches, logits and caches within STEP_REL.  llama4's chunk of 64 cuts
    the prefill and each decode step."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    tok = _tokens(cfg, 2, PROMPT, 11)
    ref_caches = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        ref_registry.init_caches(ref_cfg, 2, CONTEXT))
    caches = cast_tree(registry.init_caches(cfg, 2, CONTEXT), torch.float32)
    ref_logits, ref_caches, step = _ref_replay(ref_p, ref_cfg, tok,
                                               ref_caches)
    last, caches = registry.prefill_caches(p, cfg, torch.from_numpy(tok),
                                           caches)
    assert last.shape == (2, 1, ref_logits[-1].shape[-1])
    assert _rel(last.numpy(), ref_logits[-1]) < STEP_REL
    _check_caches(caches, ref_caches, cfg)
    assert not caches["k"][:, :, PROMPT:].any()
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


@pytest.mark.parametrize("capacity", ["own", "dropless"])
def test_prefill_is_not_prefill_caches_where_capacity_binds(weights,
                                                            capacity):
    """registry.prefill is the reference's last-only forward, whose MoE
    layers dispatch by capacity over the 80-token group; prefill_caches
    routes each token alone, as the engine's replay does.  At the configs'
    own capacity factor (1.25: capacity 50 for grok's 160 choices over 4
    experts, 25 for llama4's 80) tokens are dropped and the two differ; at
    a factor of E / k the capacity is the group and they agree.  prefill
    holds to the reference's forward either way."""
    ref_cfg, ref_p, cfg, p = weights
    if capacity == "dropless":
        factor = cfg.n_experts / cfg.top_k
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
        ref_cfg = dataclasses.replace(ref_cfg, capacity_factor=factor)
        assert moe.capacity(cfg, PROMPT) == PROMPT
    tok = _tokens(cfg, 2, PROMPT, 13)
    last = registry.prefill(p, cfg, {"tokens": torch.from_numpy(tok)})
    ref = ref_registry.forward(ref_p, ref_cfg,
                               {"tokens": jnp.asarray(tok, jnp.int32)},
                               ).logits[:, -1:]
    assert _rel(last.numpy(), ref) < FORWARD_REL
    caches = cast_tree(registry.init_caches(cfg, 2, CONTEXT), torch.float32)
    replayed, _ = registry.prefill_caches(p, cfg, torch.from_numpy(tok),
                                          caches)
    rel = _rel(last.numpy(), replayed.numpy())
    if capacity == "dropless":
        assert rel < STEP_REL
    else:
        assert moe.capacity(cfg, moe.group_size(PROMPT)) == (
            50 if cfg.top_k == 2 else 25)
        assert rel > 1e-3


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_tokens_and_series_match_reference(weights, impl):
    """Ragged prompts of 60 to 80 tokens (padded with token 0) and 12 new
    tokens in a context of 128: identical greedy tokens and accountant
    series."""
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


# -- training -----------------------------------------------------------------


def _qk_scaled(ref_params):
    """Reference params (numpy) with every layer's wq and wk scaled by
    QK_SCALE."""
    layers = dict(ref_params["layers"])
    for key in ("wq", "wk"):
        layers[key] = np.asarray(layers[key]) * np.float32(QK_SCALE)
    return {**ref_params, "layers": layers}


def test_loss_with_aux_matches_reference(weights):
    """loss_fn = CE + 0.01 x the MoE layers' aux loss, and its gradient's
    global norm, against the reference's (wq and wk scaled by QK_SCALE)."""
    ref_cfg, ref_p, cfg, _ = weights
    ref_p = _qk_scaled(jax.device_get(ref_p))
    p = tree_map(lambda t: t.requires_grad_(), params_from_numpy(ref_p, cfg))
    rng = np.random.default_rng(4)
    tok, labels = (rng.integers(0, cfg.vocab, (2, 64)) for _ in range(2))
    ref_batch = {"tokens": jnp.asarray(tok, jnp.int32),
                 "labels": jnp.asarray(labels, jnp.int32)}
    (ref_loss, ref_out), ref_grads = jax.value_and_grad(
        lambda q: ref_registry.loss_fn(q, ref_cfg, ref_batch),
        has_aux=True)(ref_p)
    loss, out = registry.loss_fn(p, cfg, {"tokens": torch.from_numpy(tok),
                                          "labels": torch.from_numpy(labels)})
    loss.backward()
    aux = float(out.aux_loss.detach())
    assert aux > 0
    assert abs(aux - float(ref_out.aux_loss)) \
        <= STEP_REL * float(ref_out.aux_loss)
    assert abs(float(loss) - float(ref_loss)) <= STEP_REL * float(ref_loss)
    norm = float(torch.sqrt(sum((t.grad.double() ** 2).sum()
                                for t in tree_leaves(p))))
    ref_norm = float(ref_opt.global_norm(ref_grads))
    assert abs(norm - ref_norm) <= STEP_REL * ref_norm


#: share of f32 params that may end more than 1e-5 of the leaf's largest
#: entry from the reference's after one AdamW step (see below)
F32_OFF_SHARE = 5e-3


def test_one_adamw_step_on_grok_matches_reference():
    """One f32 train step of grok's smoke config from the reference's
    initial state (wq and wk scaled by QK_SCALE): loss, aux loss, grad norm
    and lr within STEP_REL.  A first AdamW step moves each param by
    lr * g / (|g| + eps), +-lr where the gradient is not tiny, so where
    the sum order flips the sign of a near-zero gradient the packages move
    it 2 lr apart: every param is within 2 lr of the reference's, and all
    but a few within 1e-5 of its leaf's largest entry."""
    arch = "grok-1-314b"
    ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    state, _ = ref_train_step.init_train_state(jax.random.PRNGKey(0), ref_cfg)
    state["params"] = ref_cast_tree(state["params"], jnp.float32)
    state = jax.device_get(state)
    state["params"] = _qk_scaled(state["params"])
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, cfg.vocab, (2, 32)) for k in ("tokens",
                                                              "labels")}
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    ref_state, ref_m = jax.jit(ref_train_step.make_train_step(
        ref_cfg, ref_opt.AdamWConfig(**opt)))(
            state, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    new, m = make_train_step(cfg, optimizer.AdamWConfig(**opt))(
        state_from_numpy(state, cfg),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "aux_loss", "grad_norm", "lr"):
        assert abs(float(m[key]) - float(ref_m[key])) \
            <= STEP_REL * abs(float(ref_m[key])), key
    assert float(m["aux_loss"]) > 0
    lr = float(m["lr"])
    want = params_from_numpy(jax.device_get(ref_state["params"]), cfg)
    for got, ref in zip(tree_leaves(new["params"]), tree_leaves(want)):
        err = (got.detach() - ref).abs()
        assert float(err.max()) <= 2 * lr * (1 + 1e-6)
        off = err > 1e-5 * float(ref.abs().max())
        assert float(off.float().mean()) < F32_OFF_SHARE


# -- the bridge at full width, the CLI, the init -------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


#: params of the full configs (``jax.eval_shape`` of the reference's init)
FULL_PARAMS = {"grok-1-314b": 315_684_034_560,
               "llama4-maverick-400b-a17b": 396_658_447_360}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_full_width_params_and_caches(arch):
    """At full width the port's tree, built on the meta device, is the
    reference's key for key, shape for shape and dtype for dtype (grok's
    experts in ``layers``; llama4's ``moe_layers`` and ``dense_layers``
    stacks), and so are the plain caches, which MoE configs take even with
    kv_quant or windowed_cache set; the bridge carries a smoke tree across
    and refuses a wrong expert shape."""
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
    stacks = {"layers/w_gate": arch == "grok-1-314b",
              "moe_layers/w_gate": arch != "grok-1-314b",
              "dense_layers/w_gate": arch != "grok-1-314b"}
    assert {k: k in got for k in stacks} == stacks
    for flags in ({}, {"kv_quant": True}, {"windowed_cache": True}):
        c = dataclasses.replace(cfg, **flags)
        caches = registry.init_caches(c, 8, 1024, device="meta")
        ref_caches = jax.eval_shape(lambda: ref_registry.init_caches(
            dataclasses.replace(ref_cfg, **flags), 8, 1024))
        assert caches.keys() == ref_caches.keys() == {"k", "v"}
        assert tuple(caches["k"].shape) == tuple(ref_caches["k"].shape) == (
            cfg.n_layers, 8, 1024, cfg.n_kv_heads, cfg.resolved_head_dim)
    smoke_ref, smoke = ref_get_smoke_config(arch), get_smoke_config(arch)
    tree = jax.device_get(ref_registry.init_params(jax.random.PRNGKey(0),
                                                   smoke_ref)[0])
    port = params_from_numpy(tree, smoke)
    stack = "layers" if smoke.moe_every == 1 else "moe_layers"
    np.testing.assert_array_equal(
        port[stack]["w_up"].float().numpy(),
        np.asarray(tree[stack]["w_up"], np.float32))
    tree[stack]["w_up"] = tree[stack]["w_up"][:, 1:]
    with pytest.raises(ValueError, match=f"{stack}/w_up"):
        params_from_numpy(tree, smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_smoke_on_cpu(arch):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "2", "--prompt-len",
         "80", "--max-new", "12", "--max-context", "128"], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "family=moe" in res.stdout
    assert "24 tokens" in res.stdout


def test_draw_slices_recursively_past_the_limit(monkeypatch):
    """With DRAW_LIMIT at 1000 elements: a [3, 4, 20, 30] tensor, whose
    [4, 20, 30] slices are over the limit, is drawn slice of a slice at a
    time, with its shape, dtype and scale; a [3, 20, 30] tensor, whose
    slices fit, draws exactly what the slice-by-slice draw of the leading
    axis gives, as before; a tensor under the limit is one draw."""
    monkeypatch.setattr(module, "DRAW_LIMIT", 1000)
    b = ParamBuilder(torch.Generator().manual_seed(0))
    b.add("deep", (3, 4, 20, 30), (None,) * 4, scale=0.5)
    b.add("flat", (3, 20, 30), (None,) * 3, scale=0.5)
    b.add("small", (20, 30), (None,) * 2, scale=0.5)
    deep = b.params["deep"]
    assert deep.shape == (3, 4, 20, 30) and deep.dtype == torch.bfloat16
    assert abs(float(deep.float().std()) - 0.5) < 0.02
    assert abs(float(deep.float().mean())) < 0.02
    gen = torch.Generator().manual_seed(0)
    want = [(torch.randn((20, 30), generator=gen) * 0.5).to(torch.bfloat16)
            for _ in range(12)]
    torch.testing.assert_close(deep.reshape(12, 20, 30), torch.stack(want),
                               rtol=0, atol=0)
    want = [(torch.randn((20, 30), generator=gen) * 0.5).to(torch.bfloat16)
            for _ in range(3)]
    torch.testing.assert_close(b.params["flat"], torch.stack(want), rtol=0,
                               atol=0)
    want = (torch.randn((20, 30), generator=gen) * 0.5).to(torch.bfloat16)
    torch.testing.assert_close(b.params["small"], want, rtol=0, atol=0)


def test_draw_past_the_limit_leaves_no_reference_cycle(monkeypatch):
    """A tensor drawn slice by slice is freed with the last reference to
    its builder, with the garbage collector off: nothing of the draw keeps
    the builder alive (a self-referencing closure would, and so hold every
    weight drawn by that builder until the next collection)."""
    monkeypatch.setattr(module, "DRAW_LIMIT", 1000)
    enabled = gc.isenabled()
    gc.disable()
    try:
        b = ParamBuilder(torch.Generator().manual_seed(0))
        b.add("deep", (3, 4, 20, 30), (None,) * 4)
        ref = weakref.ref(b.params["deep"])
        del b
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
