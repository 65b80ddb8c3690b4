"""The port's Mamba2 slice against the reference, on the CPU: the SSD plain
version and adapter (the reference's Pallas kernel runs in interpret mode),
the chunked SSD, the mixer, decode, the cache-filling prefill against the
reference engine's prompt replay, the registry, the serving engine, the
early restart, the bridge at full width and the serve CLI, and the decode
step's state-update wrapper on the CPU.  The SSD and state-update kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

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
from repro.kernels.ops import ssd_mixer as ref_ssd_mixer
from repro.kernels.ref import ssd_ref as ref_ssd_ref
from repro.models import registry as ref_registry
from repro.models import ssm as ref_ssm
from repro.models.module import cast_tree as ref_cast_tree
from repro.serving import engine as ref_engine
from repro_torch.bridge import caches_from_numpy, params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import reference_fields
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.restart import NeedsLargerPartition
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import ssm_state_update as su
from repro_torch.kernels.ref import ssd_ref
from repro_torch.models import registry, ssm
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

ARCH = "mamba2-2.7b"
REPO = Path(__file__).resolve().parents[1]
F32_TOL = 2e-4      # tests/test_kernels.py:99
BF16_TOL = 5e-2     # tests/test_kernels.py:123
RANDOM_TOL = 5e-4   # tests/test_kernels.py:134
FORWARD_REL = 5e-3  # tests/test_sharding_and_layers.py:271
STEP_REL = 1e-4     # prefill / decode vs the replay: other sum orders


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _ssd_inputs(seed, b, s, h, p, n):
    """The reference tests' SSD inputs (tests/test_kernels.py:81-90), drawn
    with numpy: x, dt (post-softplus), a < 0, B, C."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5,
            np.log1p(np.exp(rng.standard_normal((b, s, h),
                                                dtype=np.float32))),
            -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.2),
            rng.standard_normal((b, s, n), dtype=np.float32) * 0.3,
            rng.standard_normal((b, s, n), dtype=np.float32) * 0.3)


def _both(args, x_dtype="f32"):
    jx = jnp.asarray(args[0]).astype(
        jnp.float32 if x_dtype == "f32" else jnp.bfloat16)
    tx = torch.from_numpy(args[0]).to(
        torch.float32 if x_dtype == "f32" else torch.bfloat16)
    return ((jx, *(jnp.asarray(a) for a in args[1:])),
            (tx, *(torch.from_numpy(a) for a in args[1:])))


# (name, b, s, h, p, n, chunk, x dtype, tol): the sweep of
# tests/test_kernels.py:93-134
SWEEP = (
    [(f"s{s}-chunk{c}", 2, s, 3, 32, 16, c, "f32", F32_TOL)
     for s, c in ((128, 32), (256, 64), (256, 128))]
    + [("ragged-s100", 1, 100, 2, 16, 8, 64, "f32", F32_TOL),
       ("dtype-f32", 1, 128, 2, 32, 16, 64, "f32", F32_TOL),
       ("dtype-bf16", 1, 128, 2, 32, 16, 64, "bf16", BF16_TOL)]
    + [(f"random-h{h}-p{p}-n{n}", 1, 128, h, p, n, 64, "f32", RANDOM_TOL)
       for h, p, n in ((1, 16, 8), (2, 32, 16), (4, 16, 16), (4, 32, 8))]
)


@pytest.mark.parametrize("case", SWEEP, ids=[c[0] for c in SWEEP])
def test_ssd_mixer_matches_reference(case):
    """The port's adapter (on the CPU: the plain sequential version) against
    the reference's Pallas kernel in interpret mode and its oracle."""
    name, b, s, h, p, n, chunk, x_dtype, tol = case
    args = _ssd_inputs(len(name) * 7 + s + h, b, s, h, p, n)
    jargs, targs = _both(args, x_dtype)
    ref_kernel = np.asarray(ref_ssd_mixer(*jargs, chunk=chunk,
                                          interpret=True).astype(jnp.float32))
    ref_y, _ = ref_ssd_ref(*_both(args)[0])      # y: f32 x, as the reference
    _, ref_state = ref_ssd_ref(*jargs)           # state: the same x as ours
    y, state = ops.ssd_mixer(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and y.shape == (b, s, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    np.testing.assert_allclose(y.float().numpy(), ref_kernel, atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref_y),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_ssd_ref_matches_reference_oracle(x_dtype):
    args = _ssd_inputs(3, 2, 64, 3, 16, 8)
    jargs, targs = _both(args, x_dtype)
    ref_y, ref_state = ref_ssd_ref(*jargs)
    y, state = ssd_ref(*targs)
    assert y.dtype == targs[0].dtype
    tol = 1e-5 if x_dtype == "f32" else 8e-3   # one bf16 rounding of y
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref_y.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,chunk", [(256, 64), (128, 128), (100, 32),
                                     (100, 64)])
def test_ssd_chunked_matches_reference(s, chunk):
    """y and the final state; at S=100 the chunk halves until it divides S
    (down to 4), as in the reference."""
    args = _ssd_inputs(s + chunk, 2, s, 3, 32, 16)
    jargs, targs = _both(args)
    ref_y, ref_state = ref_ssm.ssd_chunked(*jargs, chunk=chunk)
    y, state = ssm.ssd_chunked(*targs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state),
                               atol=F32_TOL, rtol=F32_TOL)


def test_ssd_final_state_matches_reference_chunked():
    """The adapter's final state (padded S, dt = 0 on the pad) against the
    reference's chunked SSD on the unpadded inputs."""
    args = _ssd_inputs(11, 2, 100, 3, 32, 16)
    jargs, targs = _both(args)
    _, ref_state = ref_ssm.ssd_chunked(*jargs, chunk=32)
    _, state = ops.ssd_mixer(*targs, chunk=64)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state),
                               atol=F32_TOL, rtol=F32_TOL)


def test_cpu_call_takes_plain_version_and_counts_nothing():
    targs = _both(_ssd_inputs(5, 1, 64, 2, 16, 8))[1]
    before = ssd.launches
    y, state = ssd.ssd_scan(*targs, chunk=32)
    assert ssd.launches == before
    want_y, want_state = ssd_ref(*targs)
    torch.testing.assert_close(y, want_y)
    torch.testing.assert_close(state, want_state)


@pytest.mark.parametrize("bad", ["rank", "dt_shape", "bc_shape", "dtype",
                                 "f64_dt", "head_dim", "state_dim", "chunk",
                                 "big_chunk"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dt, a, b_in, c_in = _both(_ssd_inputs(6, 1, 64, 2, 16, 8))[1]
    chunk = 32
    if bad == "rank":
        x = x[0]
    elif bad == "dt_shape":
        dt = dt[:, :, :1]
    elif bad == "bc_shape":
        c_in = c_in[..., :4]
    elif bad == "dtype":
        x = x.half()
    elif bad == "f64_dt":
        dt = dt.double()
    elif bad == "head_dim":
        x = x[..., :12]
    elif bad == "state_dim":
        b_in = c_in = torch.zeros(1, 64, 129)
    elif bad == "chunk":
        chunk = 48
    elif bad == "big_chunk":
        x, dt, b_in, c_in = (torch.cat([t] * 32, dim=1)
                             for t in (x, dt, b_in, c_in))
        chunk = 2048
    with pytest.raises((ValueError, TypeError)):
        ssd.ssd_scan(x, dt, a, b_in, c_in, chunk=chunk)


# -- the model ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Reference f32 mamba2 smoke weights and the same weights in the port."""
    ref_cfg = ref_get_smoke_config(ARCH)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    cfg = get_smoke_config(ARCH)
    return ref_cfg, ref_p, cfg, params_from_numpy(jax.device_get(ref_p), cfg)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"].items()}


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_and_values_match(smoke):
    ref = (ref_get_smoke_config if smoke else ref_get_config)(ARCH)
    out = (get_smoke_config if smoke else get_config)(ARCH)
    assert reference_fields(out) == dataclasses.asdict(ref)
    assert ssm.ssm_dims(out) == ref_ssm.ssm_dims(ref)


def test_init_params_keys_shapes_and_init_kinds(weights):
    ref_cfg, _, cfg, _ = weights
    ref_p, ref_specs = ref_registry.init_params(jax.random.PRNGKey(3),
                                                ref_cfg)
    gen = torch.Generator().manual_seed(3)
    p, specs = registry.init_params(gen, cfg)
    assert specs == jax.tree_util.tree_map(
        tuple, ref_specs, is_leaf=lambda x: isinstance(x, tuple))
    assert set(p["layers"]) == set(ref_p["layers"])
    for k, v in p["layers"].items():
        ref = np.asarray(ref_p["layers"][k].astype(jnp.float32))
        assert tuple(v.shape) == ref.shape and v.dtype == torch.bfloat16
        if k in ("conv_b", "A_log", "D", "dt_bias", "norm"):  # constants
            np.testing.assert_array_equal(v.float().numpy(), ref)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq", [128, 40])
def test_ssm_forward_matches_reference(weights, impl, seq):
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, ssm_impl=impl)
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, cfg.d_model), dtype=np.float32)
    ref = ref_ssm.ssm_forward(_layer0(ref_p), jnp.asarray(x), ref_cfg)
    out = ssm.ssm_forward(_layer0(p), torch.from_numpy(x), cfg)
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < FORWARD_REL


def test_ssm_decode_step_matches_reference(weights):
    """One step from random caches: output and both new caches."""
    ref_cfg, ref_p, cfg, p = weights
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    caches = ssm.init_ssm_cache(cfg, 1, 3)
    conv = rng.standard_normal(caches["conv"].shape[1:], dtype=np.float32)
    state = rng.standard_normal(caches["state"].shape[1:], dtype=np.float32)
    ref = ref_ssm.ssm_decode_step(_layer0(ref_p), jnp.asarray(x),
                                  jnp.asarray(conv), jnp.asarray(state),
                                  ref_cfg)
    out = ssm.ssm_decode_step(_layer0(p), torch.from_numpy(x),
                              torch.from_numpy(conv), torch.from_numpy(state),
                              cfg)
    for got, want in zip(out, ref):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < STEP_REL


def _update_inputs(seed, b, h, p, n, dtype):
    """One decode step's state-update inputs: state [B,H,P,N] f32, x
    [B,H,P], dt [B,H], dt_bias, A_log, D [H], B, C [B,N]."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * scale)
    state = rnd(b, h, p, n)
    rest = (rnd(b, h, p), rnd(b, h), rnd(h, scale=0.5), rnd(h, scale=0.5),
            rnd(h), rnd(b, n, scale=0.3), rnd(b, n, scale=0.3))
    return (state, *(t.to(dtype) for t in rest))


def _todays_update(state, x, dt, dt_bias, a_log, d, b, c):
    """ssm_decode_step's state update as it was written before the
    wrapper, line for line."""
    xh = x.float()
    dt1 = torch.nn.functional.softplus(dt.float() + dt_bias.float())
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt1 * a)
    outer = torch.einsum("bhp,bn->bhpn", dt1[..., None] * xh, b.float())
    state = state * decay[..., None, None] + outer
    y = torch.einsum("bhpn,bn->bhp", state, c.float())
    y = y + d.float()[None, :, None] * xh
    return y, state


# (B, H, P, N): the smoke configs', zamba2's and mamba2's widths, cut in B
# and H
UPDATE_SHAPES = [(3, 4, 128, 16), (2, 3, 64, 64), (2, 3, 64, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", UPDATE_SHAPES, ids=str)
def test_state_update_cpu_path_is_the_plain_expression(shape, dtype):
    """On the CPU the wrapper computes the decode step's update exactly as
    ssm_decode_step did before it, bit for bit, and launches nothing."""
    args = _update_inputs(sum(shape), *shape, dtype)
    before = su.launches
    y, state = su.ssm_state_update(*args)
    assert su.launches == before
    want_y, want_state = _todays_update(*args)
    assert y.dtype == state.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


@pytest.mark.parametrize("shape", UPDATE_SHAPES, ids=str)
def test_state_update_cpu_path_returns_a_new_state(shape):
    """Off the card the state comes back as a new tensor and the one given
    keeps its values: a caller that gets its cache back knows it was left
    stale, and copies a new state in."""
    args = _update_inputs(7, *shape, torch.float32)
    kept = args[0].clone()
    _, state = su.ssm_state_update(*args)
    assert state is not args[0]
    assert state.data_ptr() != args[0].data_ptr()
    assert torch.equal(args[0], kept)
    assert not torch.equal(state, kept)


@pytest.mark.parametrize("bad", ["rank", "x_shape", "bc_shape", "bias_shape",
                                 "state_dtype", "half", "mixed_dtype",
                                 "state_dim"])
def test_state_update_rejects_what_the_kernel_does_not_take(bad):
    args = list(_update_inputs(3, 2, 3, 64, 16, torch.float32))
    if bad == "rank":
        args[0] = args[0][0]
    elif bad == "x_shape":
        args[1] = args[1][..., :32]
    elif bad == "bc_shape":
        args[7] = args[7][:, :8]
    elif bad == "bias_shape":
        args[3] = args[3][:2]
    elif bad == "state_dtype":
        args[0] = args[0].double()
    elif bad == "half":
        args[1:] = [t.half() for t in args[1:]]
    elif bad == "mixed_dtype":
        args[1] = args[1].to(torch.bfloat16)
    elif bad == "state_dim":
        args[0] = torch.zeros(2, 3, 64, 32)
        args[6] = args[7] = torch.zeros(2, 32)
    with pytest.raises((ValueError, TypeError)):
        su.ssm_state_update(*args)


def _in_place_update(calls):
    """The card's contract on the CPU: the plain update written into the
    state given, which is returned."""
    def update(state, *rest):
        calls.append(state)
        y, new = su.ssm_state_update_ref(state, *rest)
        state.copy_(new)
        return y, state
    return update


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b"])
def test_decode_step_takes_a_state_updated_in_place(arch, monkeypatch):
    """Both callers of ssm_decode_step (the ssm and the hybrid decode step)
    give the same logits and caches, bit for bit, whether the state comes
    back as a new tensor (the CPU) or as the cache itself updated in place
    (the card's kernel), once per layer per step."""
    cfg = dataclasses.replace(get_smoke_config(arch), ssm_impl="pallas")
    gen = torch.Generator().manual_seed(0)
    params, _ = registry.init_params(gen, cfg)
    tok = torch.from_numpy(_tokens(cfg, 2, 5, 3))
    out = {}
    calls = []
    for mode in ("new", "in_place"):
        if mode == "in_place":
            monkeypatch.setattr(ssm, "ssm_state_update",
                                _in_place_update(calls))
        caches = registry.init_caches(cfg, 2, 8)
        logits = []
        with torch.no_grad():
            for pos in range(tok.shape[1]):
                lg, caches = registry.decode_step(
                    params, cfg, tok[:, pos:pos + 1], pos, caches)
                logits.append(lg)
        out[mode] = (logits, caches)
    n_ssm = sum(c["state"].shape[0] for k, c in out["new"][1].items()
                if k.startswith("ssm"))
    assert len(calls) == n_ssm * tok.shape[1]
    for got, want in zip(out["in_place"][0], out["new"][0]):
        assert torch.equal(got, want)
    for name, c in out["new"][1].items():
        got = out["in_place"][1][name]
        if isinstance(c, dict):
            assert all(torch.equal(got[k], c[k]) for k in c), name
        else:
            assert torch.equal(got, c), name


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b"])
def test_decode_step_on_the_plain_path_never_reaches_the_kernel(arch,
                                                                monkeypatch):
    """``ssm_impl`` 'xla' decodes through the plain version and never calls
    the kernel's wrapper, and gives the 'pallas' path's logits and caches
    bit for bit on the CPU, where the wrapper runs the plain version."""
    cfg = get_smoke_config(arch)
    assert cfg.ssm_impl == "xla"
    gen = torch.Generator().manual_seed(0)
    params, _ = registry.init_params(gen, cfg)
    tok = torch.from_numpy(_tokens(cfg, 2, 4, 5))
    out = {}
    for impl in ("pallas", "xla"):
        if impl == "xla":
            def refuse(*args):
                raise AssertionError("the plain path called the wrapper")
            monkeypatch.setattr(ssm, "ssm_state_update", refuse)
        c = dataclasses.replace(cfg, ssm_impl=impl)
        caches = registry.init_caches(c, 2, 8)
        logits = []
        with torch.no_grad():
            for pos in range(tok.shape[1]):
                lg, caches = registry.decode_step(
                    params, c, tok[:, pos:pos + 1], pos, caches)
                logits.append(lg)
        out[impl] = (logits, caches)
    for got, want in zip(out["xla"][0], out["pallas"][0]):
        assert torch.equal(got, want)
    for name, c in out["pallas"][1].items():
        got = out["xla"][1][name]
        if isinstance(c, dict):
            assert all(torch.equal(got[k], c[k]) for k in c), name
        else:
            assert torch.equal(got, c), name


def _ref_replay(ref_p, ref_cfg, tok, context):
    caches = ref_registry.init_caches(ref_cfg, tok.shape[0], context)
    step = jax.jit(lambda p, t, i, c: ref_registry.decode_step(
        p, ref_cfg, t, i, c))
    logits = []
    for pos in range(tok.shape[1]):
        lg, caches = step(ref_p, jnp.asarray(tok[:, pos:pos + 1], jnp.int32),
                          jnp.int32(pos), caches)
        logits.append(np.asarray(lg))
    return logits, jax.device_get(caches)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq", [40, 128, 2])
def test_prefill_matches_reference_replay(weights, impl, seq):
    """registry.prefill_caches (one forward that fills the conv and state
    caches) against the reference engine's prompt replay through
    decode_step; a 2-token prompt is shorter than the conv window."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, ssm_impl=impl)
    tok = _tokens(cfg, 2, seq, seq)
    ref_logits, ref_caches = _ref_replay(ref_p, ref_cfg, tok, 160)
    caches = registry.init_caches(cfg, 2, 160)
    last, caches = registry.prefill_caches(p, cfg, torch.from_numpy(tok),
                                           caches)
    assert last.shape == (2, 1, ref_logits[-1].shape[-1])
    assert _rel(last.numpy(), ref_logits[-1]) < STEP_REL
    want = caches_from_numpy(ref_caches, cfg, 2, 160)
    for name in ("conv", "state"):
        got = caches["ssm"][name]
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want["ssm"][name].numpy()) < STEP_REL, name
    if seq < cfg.conv_width - 1:   # zero rows in front of a short prompt
        assert not caches["ssm"]["conv"][:, :, :cfg.conv_width - 1 - seq].any()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_registry_forward_matches_reference(weights, impl):
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, ssm_impl=impl)
    tok = _tokens(cfg, 2, 128, 7)
    ref = ref_registry.forward(ref_p, ref_cfg,
                               {"tokens": jnp.asarray(tok, jnp.int32)}).logits
    out = registry.forward(p, cfg, {"tokens": torch.from_numpy(tok)}).logits
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < FORWARD_REL
    last = registry.prefill(p, cfg, {"tokens": torch.from_numpy(tok)})
    torch.testing.assert_close(last, out[:, -1:], rtol=1e-5, atol=1e-5)


def test_decode_loop_matches_reference(weights):
    ref_cfg, ref_p, cfg, p = weights
    tok = _tokens(cfg, 2, 12, 11)
    ref_logits, ref_caches = _ref_replay(ref_p, ref_cfg, tok, 16)
    caches = registry.init_caches(cfg, 2, 16)
    for pos in range(tok.shape[1]):
        lg, caches = registry.decode_step(
            p, cfg, torch.from_numpy(tok[:, pos:pos + 1]), pos, caches)
        assert _rel(lg.numpy(), ref_logits[pos]) < STEP_REL, pos
    want = caches_from_numpy(ref_caches, cfg, 2, 16)
    for name in ("conv", "state"):
        assert _rel(caches["ssm"][name].numpy(),
                    want["ssm"][name].numpy()) < STEP_REL


def test_unported_families_raise():
    """The MoE family is ported: both MoE smoke configs, built from the
    reference's fields, take the plain [L,B,C,KH,hd] caches, also with
    kv_quant or windowed_cache set, as the reference gives them.  The
    decode cache variants are ported too: a dense config that asks for the
    int8 or the windowed ring cache gets the reference's cache tree."""
    from repro_torch.configs import ModelConfig
    for arch in ("grok-1-314b", "llama4-maverick-400b-a17b"):
        cfg = ModelConfig(**dataclasses.asdict(ref_get_smoke_config(arch)))
        for flags in ({}, {"kv_quant": True}, {"windowed_cache": True}):
            caches = registry.init_caches(
                dataclasses.replace(cfg, **flags), 1, 8)
            assert set(caches) == {"k", "v"}
            assert caches["k"].shape == (cfg.n_layers, 1, 8, cfg.n_kv_heads,
                                         cfg.resolved_head_dim)
    dense = ModelConfig(**dataclasses.asdict(
        ref_get_smoke_config("gemma3-27b")))
    for flags in ({"kv_quant": True}, {"windowed_cache": True}):
        caches = registry.init_caches(dataclasses.replace(dense, **flags), 1,
                                      8)
        want = ref_registry.init_caches(dataclasses.replace(
            ref_get_smoke_config("gemma3-27b"), **flags), 1, 8)
        assert caches.keys() == want.keys()
        for name, leaf in want.items():
            assert tuple(caches[name].shape) == leaf.shape, name
            assert str(caches[name].dtype) == f"torch.{leaf.dtype.name}"


# -- serving -----------------------------------------------------------------------


def _pair_requests(prompts, max_new):
    return ([ref_engine.Request(uid=i, prompt=q, max_new_tokens=max_new)
             for i, q in enumerate(prompts)],
            [Request(uid=i, prompt=q, max_new_tokens=max_new)
             for i, q in enumerate(prompts)])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_tokens_and_series_match_reference(weights, impl):
    """Ragged prompts (padded with token 0 at the end, as both engines do):
    identical greedy tokens and accountant series."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, ssm_impl=impl)
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


def test_early_restart_same_step_and_profile(weights):
    ref_cfg, ref_p, cfg, p = weights
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


# -- the bridge at full width, and the CLI -------------------------------------------


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


def test_bridge_carries_full_width_params_and_caches(weights):
    """The bridge holds a reference tree to the port's own tree for the
    config, built on the meta device.  At full mamba2-2.7b width that tree
    is the reference's key for key, shape for shape and dtype for dtype
    (``jax.eval_shape`` allocates nothing), so the bridge takes the
    reference's full-width params and caches; a wrong shape is refused."""
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda k: ref_registry.init_params(k, ref_cfg)[0],
                            jax.random.PRNGKey(0))
    want = _same_leaves(registry.init_params(None, cfg, device="meta")[0],
                        shapes)
    n_params = sum(int(np.prod(v.shape)) for v in want.values())
    assert n_params == 2_702_968_320
    cache_shapes = jax.eval_shape(
        lambda: ref_registry.init_caches(ref_cfg, 8, 1024))
    caches = registry.init_caches(cfg, 8, 1024, device="meta")
    _same_leaves(caches, cache_shapes)
    assert caches["ssm"]["state"].shape == (64, 8, 80, 64, 128)
    assert caches["ssm"]["conv"].shape == (64, 8, 3, 5376)
    assert caches["ssm"]["state"].dtype == torch.float32
    _, ref_p, smoke_cfg, _ = weights
    bad = jax.device_get(ref_p)
    bad["layers"]["conv_w"] = bad["layers"]["conv_w"][:, 1:]
    with pytest.raises(ValueError, match="layers/conv_w"):
        params_from_numpy(bad, smoke_cfg)


def test_serve_cli_runs_mamba2_smoke_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "12",
         "--partition-gb", "0.0001"], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "family=ssm" in res.stdout
    assert "EARLY RESTART" in res.stdout and "24 tokens" in res.stdout
