"""The port's dense decoder (forward, decode_step, prefill) against the
reference's, on bridged f32 smoke weights, on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import registry as ref_registry
from repro.models.module import cast_tree as ref_cast_tree
from repro_torch.bridge import caches_from_numpy, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import reference_fields
from repro_torch.kernels import ops
from repro_torch.models import attention, registry, transformer

ARCH = "qwen3-0.6b"
FORWARD_REL = 5e-3   # tests/test_sharding_and_layers.py:271
STEP_REL = 1e-4      # prefill vs replay: same arithmetic, other sum order
#: a bf16 cache entry is the rounding of an f32 value that agrees to ~1e-6;
#: where that value sits on a rounding boundary the two round one step apart
BF16_STEP = 2.0 ** -7  # one bf16 ulp, relative to the value, at most


def _rel(out, ref):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


@pytest.fixture(scope="module")
def weights():
    """Reference f32 smoke weights and the same weights in the port."""
    ref_cfg = ref_get_smoke_config(ARCH)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    cfg = get_smoke_config(ARCH)
    return ref_cfg, ref_p, cfg, params_from_numpy(jax.device_get(ref_p), cfg)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the model's calls into the flash adapter (on the CPU the
    wrapper runs its plain version, which the launch counter skips)."""
    calls = []
    real = ops.flash_mha

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(attention.ops, "flash_mha", spy)
    return calls


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq,q_block", [(128, 512), (128, 64), (40, 512)])
def test_forward_matches_reference(weights, flash_calls, impl, seq, q_block):
    """The port at attn_impl xla (plain, q-blocked when S > q_block) and
    pallas (the flash adapter) against the reference's XLA forward."""
    ref_cfg, ref_p, cfg, p = weights
    ref_cfg = dataclasses.replace(ref_cfg, attn_q_block=q_block)
    cfg = dataclasses.replace(cfg, attn_impl=impl, attn_q_block=q_block)
    tok = _tokens(cfg, 2, seq, 7)
    ref = ref_registry.forward(ref_p, ref_cfg,
                               {"tokens": jnp.asarray(tok, jnp.int32)}).logits
    out = registry.forward(p, cfg, {"tokens": torch.from_numpy(tok)}).logits
    assert out.shape == ref.shape
    assert _rel(out, ref) < FORWARD_REL
    assert len(flash_calls) == (cfg.n_layers if impl == "pallas" else 0)


def test_prefill_logits_are_forward_last_position(weights):
    _, _, cfg, p = weights
    batch = registry.make_dummy_batch(cfg, 2, 24, seed=3)
    assert batch["tokens"].shape == batch["labels"].shape == (2, 24)
    assert int(batch["tokens"].max()) < cfg.vocab
    last = registry.prefill(p, cfg, batch)
    full = registry.forward(p, cfg, batch).logits
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_vlm_forward_with_patches_matches_reference(impl):
    """The VLM branch: stub patch embeddings override the first positions
    (pixtral's smoke config, the port's own copy)."""
    ref_cfg = ref_get_smoke_config("pixtral-12b")
    cfg = dataclasses.replace(get_smoke_config("pixtral-12b"),
                              attn_impl=impl)
    assert reference_fields(cfg) == dataclasses.asdict(
        dataclasses.replace(ref_cfg, attn_impl=impl))
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(4), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    p = params_from_numpy(jax.device_get(ref_p), cfg)
    batch = registry.make_dummy_batch(cfg, 2, 40, seed=9)
    assert batch["patches"].shape == (2, cfg.vision_tokens, cfg.d_model)
    ref = ref_registry.forward(ref_p, ref_cfg, {
        "tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32),
        "patches": jnp.asarray(batch["patches"].float().numpy()
                               ).astype(jnp.bfloat16)}).logits
    out = registry.forward(p, cfg, batch).logits
    assert _rel(out, ref) < FORWARD_REL


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


def _check_cache(out, ref):
    """Every entry within one bf16 rounding step, and the whole cache
    within STEP_REL in norm."""
    out, ref = out.float().numpy(), ref.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=BF16_STEP, atol=0)
    assert np.linalg.norm(out - ref) <= STEP_REL * np.linalg.norm(ref)


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
    for name in ("k", "v"):
        assert caches[name].dtype == torch.bfloat16
        _check_cache(caches[name], want[name])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_matches_reference_replay(weights, flash_calls, impl):
    """transformer.prefill (one forward that fills the bf16 cache) against
    the reference engine's prompt replay through decode_step."""
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    tok = _tokens(cfg, 3, 20, 5)
    ref_logits, ref_caches = _ref_replay(ref_p, ref_cfg, tok, 32)
    caches = registry.init_caches(cfg, 3, 32)
    last, caches = transformer.prefill(p, cfg, torch.from_numpy(tok), caches)
    assert last.shape == (3, 1, ref_logits[-1].shape[-1])
    assert _rel(last.numpy(), ref_logits[-1]) < STEP_REL
    want = caches_from_numpy(ref_caches, cfg, 3, 32)
    for name in ("k", "v"):
        _check_cache(caches[name], want[name])
        assert not caches[name][:, :, 20:].any()  # nothing past the prompt
    assert len(flash_calls) == (cfg.n_layers if impl == "pallas" else 0)


def test_bridge_checks_keys_and_shapes(weights):
    ref_cfg, ref_p, cfg, _ = weights
    host = jax.device_get(ref_p)
    flat = {}

    def flatten(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v
    flatten(host)
    from_flat = params_from_numpy(flat, cfg)
    torch.testing.assert_close(from_flat["layers"]["wq"],
                               torch.from_numpy(np.array(
                                   host["layers"]["wq"])))
    bad = dict(flat, **{"layers/wq": flat["layers/wq"][:, :1]})
    with pytest.raises(ValueError, match="layers/wq"):
        params_from_numpy(bad, cfg)
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "final_norm"}, cfg)


def test_bridge_keeps_bf16_bits():
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(1),
                                        ref_get_smoke_config(ARCH))
    host = jax.device_get(ref_p)
    p = params_from_numpy(host, get_smoke_config(ARCH))
    assert p["embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p["embedding"].view(torch.int16).numpy(),
        np.asarray(host["embedding"]).view(np.int16))


def test_checkpoint_loads_into_port(tmp_path):
    from repro.training.checkpoint import save_checkpoint
    from repro_torch.bridge import load_npz_params
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(2),
                                        ref_get_smoke_config(ARCH))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"params": ref_p}, step=1)
    p = load_npz_params(path, get_smoke_config(ARCH))
    np.testing.assert_array_equal(
        p["layers"]["w_up"].view(torch.int16).numpy(),
        np.asarray(jax.device_get(ref_p)["layers"]["w_up"]).view(np.int16))
