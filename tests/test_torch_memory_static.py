"""The port's static memory tier against the reference, on the CPU:
``core/memory/static_estimator.py`` (parameter counts, KV cache bytes, the
train and serve footprints) on every full and smoke config, the MoE
configs cut to ``ONE_CARD_LAYERS`` and gemma3-27b's cache variants, and
``core/memory/workspace.py``.

Every comparison is against live ``repro`` in this interpreter, with
``==``.  The estimator's blind spots are the reference's and stay: it
counts every layer of a MoE config as MoE whatever ``moe_every`` says,
and leaves out the encoder-decoder's f32 encoder attention slabs."""

import dataclasses

import pytest

from repro import configs as ref_configs
from repro.core.memory import static_estimator as ref_est
from repro.core.memory import workspace as ref_ws
from repro_torch import configs
from repro_torch.core.memory import static_estimator as est
from repro_torch.core.memory import workspace as ws

ARCHS = list(configs.ALL_ARCHS)
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab", "act", "qk_norm", "tie_embeddings",
          "n_experts", "top_k", "moe_every", "sliding_window",
          "global_every", "attention_chunk", "windowed_cache", "kv_quant",
          "attn_every", "enc_layers", "ssm_state", "ssm_expand",
          "ssm_heads", "conv_width")

#: chip_smoke.py's serving runs (batch 8): arch, context, config changes,
#: and the reference's estimate_serve total bytes there
PHASE_ESTIMATES = [
    ("qwen3-0.6b", 1024, {}, 2132148224),
    ("mamba2-2.7b", 1024, {}, 6099207168),
    ("zamba2-7b", 1024, {}, 15433178560),
    ("whisper-medium", 448, {}, 2220871680),
    ("qwen3-1.7b", 1024, {}, 4381722624),
    ("gemma-2b", 1024, {}, 5164388352),
    ("gemma3-27b", 2048, {}, 62340922880),
    ("gemma3-27b", 2048, {"windowed_cache": True}, 58851261952),
    ("gemma3-27b", 2048, {"kv_quant": True}, 62340922880),
    ("pixtral-12b", 1024, {}, 24498186240),
    ("grok-1-314b", 1024, {"n_layers": 6}, 60854857728),
    ("llama4-maverick-400b-a17b", 1024, {"n_layers": 4}, 131563481088),
]


def _pair(arch, smoke=False, **changes):
    get = configs.get_smoke_config if smoke else configs.get_config
    ref_get = ref_configs.get_smoke_config if smoke else ref_configs.get_config
    return (dataclasses.replace(get(arch), **changes),
            dataclasses.replace(ref_get(arch), **changes))


def _footprint(fp):
    return dataclasses.asdict(fp), fp.total_gb


def _call(fn, *args, **kwargs):
    """``fn``'s result, or the type and text of what it raised (the
    mamba2 smoke config has no attention heads, so a head dim divides by
    zero in both packages)."""
    try:
        out = fn(*args, **kwargs)
    except ArithmeticError as exc:
        return type(exc).__name__, str(exc)
    return _footprint(out) if hasattr(out, "total_gb") else out


def _all_estimates(mod, cfg):
    """Every estimator entry point of ``mod`` on ``cfg`` at a few shapes."""
    out = {"param_count": _call(mod.param_count, cfg),
           "active_param_count": _call(mod.active_param_count, cfg)}
    for batch, n in ((1, 128), (8, 1024), (8, 2048), (32, 4096)):
        out[f"kv {batch} {n}"] = _call(mod.kv_cache_bytes, cfg, batch, n)
        out[f"kv f32 {batch} {n}"] = _call(mod.kv_cache_bytes, cfg, batch,
                                           n, mod.FP32)
        out[f"serve {batch} {n}"] = _call(mod.estimate_serve, cfg, batch, n)
        out[f"serve f32 {batch} {n}"] = _call(mod.estimate_serve, cfg,
                                              batch, n, mod.FP32)
        out[f"train {batch} {n}"] = _call(mod.estimate_train, cfg, batch, n)
        out[f"train sgd {batch} {n}"] = _call(mod.estimate_train, cfg,
                                              batch, n, optimizer="sgd")
        for policy in ("layer", "none"):
            out[f"act {policy} {batch} {n}"] = _call(
                mod.activation_bytes_train, cfg, batch, n,
                checkpoint_policy=policy)
    return out


def test_config_fields_read_by_the_estimator_are_the_reference():
    """Every ModelConfig field the estimator reads exists in the port with
    the reference's default."""
    port = {f.name: f.default for f in dataclasses.fields(configs.ModelConfig)}
    ref = {f.name: f.default
           for f in dataclasses.fields(ref_configs.ModelConfig)}
    for name in FIELDS:
        assert name in port and port[name] == ref[name], name


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_estimates_equal_the_reference(arch, smoke):
    cfg, ref_cfg = _pair(arch, smoke)
    assert _all_estimates(est, cfg) == _all_estimates(ref_est, ref_cfg)


@pytest.mark.parametrize("arch", list(configs.ONE_CARD_LAYERS))
def test_one_card_moe_depths_equal_the_reference(arch):
    n = configs.ONE_CARD_LAYERS[arch]
    cfg, ref_cfg = _pair(arch, n_layers=n)
    assert _all_estimates(est, cfg) == _all_estimates(ref_est, ref_cfg)


@pytest.mark.parametrize("variant", [{"windowed_cache": True},
                                     {"kv_quant": True},
                                     {"windowed_cache": True,
                                      "kv_quant": True}],
                         ids=["windowed", "int8", "both"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_gemma3_cache_variants_equal_the_reference(variant, smoke):
    cfg, ref_cfg = _pair("gemma3-27b", smoke, **variant)
    assert _all_estimates(est, cfg) == _all_estimates(ref_est, ref_cfg)


@pytest.mark.parametrize("arch,context,changes,total", PHASE_ESTIMATES)
def test_chip_phase_estimates_are_the_reference_bytes(arch, context, changes,
                                                      total):
    """The serving estimates chip_smoke.py prints beside each peak."""
    cfg, ref_cfg = _pair(arch, **changes)
    got = est.estimate_serve(cfg, 8, context)
    assert _footprint(got) == _footprint(
        ref_est.estimate_serve(ref_cfg, 8, context))
    assert got.total_bytes == total


def test_training_estimate_of_the_chip_run_is_the_reference():
    cfg, ref_cfg = _pair("qwen3-0.6b")
    got = est.estimate_train(cfg, 8, 512)
    assert _footprint(got) == _footprint(ref_est.estimate_train(ref_cfg, 8,
                                                                512))
    assert round(got.total_gb, 3) == 6.911


def test_known_blind_spots_stay_the_reference_behaviour():
    """llama4 interleaves dense and MoE layers (moe_every 2), yet the
    estimator counts every layer's experts, as the reference does."""
    cfg, _ = _pair("llama4-maverick-400b-a17b", n_layers=4)
    assert cfg.moe_every == 2
    mlp = 3 * cfg.d_model * cfg.d_ff
    per_layer_moe = cfg.n_experts * mlp + cfg.d_model * cfg.n_experts
    assert est.param_count(cfg) - est.param_count(
        dataclasses.replace(cfg, n_layers=3)) == \
        est._attn_params(cfg) + per_layer_moe + 2 * cfg.d_model


@pytest.mark.parametrize("value", [None, ":4096:8", ":4096:2,:16384:2",
                                   ":4096:2:16:8",
                                   ":16:8", "", "garbage", ":0:0"])
def test_cublas_workspace_config_equals_the_reference(value, monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert ws.parse_cublas_workspace_config(value) == \
        ref_ws.parse_cublas_workspace_config(value)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    assert ws.parse_cublas_workspace_config(value) == \
        ref_ws.parse_cublas_workspace_config(value)


def test_unset_cublas_variable_defaults_as_the_reference(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert ws.parse_cublas_workspace_config() == \
        ref_ws.parse_cublas_workspace_config() == 4096 * 1024 * 8


def test_layer_walk_and_runtime_context_equal_the_reference():
    for n_layers, d_model in ((2, 256), (28, 1024), (62, 5376)):
        for kw in ({}, {"bytes_per_unit": 4.0, "multiplier": 1.5}):
            assert ws.per_layer_workspace_walk(n_layers, d_model, **kw) == \
                ref_ws.per_layer_workspace_walk(n_layers, d_model, **kw)
    assert ws.RUNTIME_CONTEXT_BYTES == ref_ws.RUNTIME_CONTEXT_BYTES
    assert not hasattr(ws, "xla_scratch_bytes")
