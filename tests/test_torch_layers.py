"""The port's configs, ParamBuilder and layers against the reference's,
on the CPU, from the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers, registry
from repro_torch.models.module import (ParamBuilder, cast_tree, param_bytes,
                                       param_count)

ARCH = "qwen3-0.6b"
# f32: the two frameworks' kernels sum and round in other orders;
# bf16: one rounding step of the stored result (at most 2**-7 relative)
TOL = {"f32": 2e-6, "bf16": 8e-3}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(x, dt):
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _close(out, ref, dt):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dt], rtol=TOL[dt])


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_and_values_match(smoke):
    ref = (ref_get_smoke_config if smoke else ref_get_config)(ARCH)
    out = (get_smoke_config if smoke else get_config)(ARCH)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert out.resolved_head_dim == ref.resolved_head_dim
    assert out.kv_groups == ref.kv_groups


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm(dt):
    rng = _rng(0)
    xj, xt = _pair(rng.standard_normal((2, 8, 64), dtype=np.float32), dt)
    wj, wt = _pair(rng.standard_normal(64, dtype=np.float32), dt)
    _close(layers.rmsnorm(xt, wt, 1e-6), ref_layers.rmsnorm(xj, wj, 1e-6), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_rope(dt):
    rng = _rng(1)
    xj, xt = _pair(rng.standard_normal((2, 8, 4, 64), dtype=np.float32), dt)
    pos = rng.integers(0, 1000, (2, 8))
    ref = ref_layers.apply_rope(xj, jnp.asarray(pos, jnp.int32), 1e6)
    out = layers.apply_rope(xt, torch.from_numpy(pos), 1e6)
    # angles up to 1e3 rad: cos/sin of two libraries differ in the last bits
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=max(TOL[dt], 2e-5), rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_embed_tokens_lookup_is_bit_equal_to_onehot(dt):
    cfg = get_smoke_config(ARCH)
    assert cfg.embed_impl == "onehot"
    rng = _rng(2)
    pv = layers.padded_vocab(cfg)
    tj, tt = _pair(rng.standard_normal((pv, cfg.d_model), dtype=np.float32),
                   dt)
    tok = rng.integers(0, cfg.vocab, (2, 7))
    ref = ref_layers.embed_tokens({"embedding": tj},
                                  jnp.asarray(tok, jnp.int32),
                                  ref_get_smoke_config(ARCH))
    out = layers.embed_tokens({"embedding": tt}, torch.from_numpy(tok), cfg)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_unembed(dt):
    cfg = get_smoke_config(ARCH)
    rng = _rng(3)
    pv = layers.padded_vocab(cfg)
    tj, tt = _pair(rng.standard_normal((pv, cfg.d_model), dtype=np.float32)
                   * 0.05, dt)
    xj, xt = _pair(rng.standard_normal((2, 3, cfg.d_model),
                                       dtype=np.float32), dt)
    ref = ref_layers.unembed({"embedding": tj}, xj,
                             ref_get_smoke_config(ARCH))
    out = layers.unembed({"embedding": tt}, xt, cfg)
    tol = TOL[dt] * 10 if dt == "f32" else TOL[dt]  # 256-term dots
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp(act, dt):
    cfg = dataclasses.replace(get_smoke_config(ARCH), act=act)
    ref_cfg = dataclasses.replace(ref_get_smoke_config(ARCH), act=act)
    rng = _rng(4)
    d, f = cfg.d_model, cfg.d_ff
    pj, pt = {}, {}
    for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                        ("w_down", (f, d))):
        pj[name], pt[name] = _pair(rng.standard_normal(shape,
                                                       dtype=np.float32)
                                   / np.sqrt(shape[0]), dt)
    xj, xt = _pair(rng.standard_normal((2, 5, d), dtype=np.float32), dt)
    ref = ref_layers.mlp(pj, xj, ref_cfg)
    out = layers.mlp(pt, xt, cfg)
    tol = TOL[dt] * 10 if dt == "f32" else 2 * TOL[dt]  # two bf16 products
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape),
                               str(v.dtype).removeprefix("torch."))
    return out


def test_param_tree_matches_reference_smoke():
    ref_p, ref_specs = ref_registry.init_params(jax.random.PRNGKey(0),
                                                ref_get_smoke_config(ARCH))
    gen = torch.Generator().manual_seed(0)
    p, specs = registry.init_params(gen, get_smoke_config(ARCH))
    want = _shapes(ref_p)
    assert _shapes(p) == want
    assert specs == ref_specs
    assert param_count(p) == sum(int(np.prod(s)) for s, _ in want.values())
    assert param_bytes(p) == 2 * param_count(p)          # bf16 default
    assert param_bytes(cast_tree(p, torch.float32)) == 4 * param_count(p)


def test_param_init_scales():
    """Normal init at 1/sqrt(fan_in) with the reference's fan_in (the
    second-to-last axis), the embedding at 1, ones for norms."""
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(1)
    p, _ = registry.init_params(gen, cfg)
    lyr = p["layers"]
    assert float(p["embedding"].float().std()) == pytest.approx(1.0, rel=0.05)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert float(lyr[name].float().std()) == pytest.approx(
            lyr[name].shape[-2] ** -0.5, rel=0.05), name
    assert bool((lyr["norm1"] == 1).all()) and bool((p["final_norm"] == 1)
                                                    .all())


def test_param_tree_matches_reference_full_size_without_allocating():
    ref_p = jax.eval_shape(
        lambda k: ref_registry.init_params(k, ref_get_config(ARCH))[0],
        jax.random.PRNGKey(0))
    p, _ = registry.init_params(None, get_config(ARCH), device="meta")
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(p))
    assert _shapes(p) == _shapes(ref_p)
    # ~0.6B parameters, ~1.19 GB in bf16
    assert 5.9e8 < param_count(p) < 6.0e8


def test_param_add_rejects_rank_mismatch():
    b = ParamBuilder(torch.Generator(), "cpu")
    with pytest.raises(ValueError):
        b.add("w", (2, 3), ("embed",))
