"""The port's training path (loss, AdamW, data, train step, checkpoints,
the trainer) against the reference's, on the CPU.

Both packages start from one state: the reference's, carried across by
``bridge.state_from_numpy``.  Each reference step is jitted once per
module (module-scoped fixtures).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.module import cast_tree as ref_cast_tree
from repro.training import checkpoint as ref_checkpoint
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_train_step
from repro_torch.bridge import (load_npz_params, params_from_numpy,
                                state_from_numpy)
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import registry, transformer
from repro_torch.models.layers import cross_entropy_loss, embed_tokens
from repro_torch.models.module import tree_leaves
from repro_torch.training import checkpoint, data, optimizer
from repro_torch.training.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-0.6b", "mamba2-2.7b", "zamba2-7b"]
#: f32 loss and grad norm, port vs reference, over a 5-step trace: the same
#: arithmetic summed in other orders (the issue's limit)
TRACE_REL = 1e-4
#: f32 scalars and params after one AdamW step: the same expression in f32,
#: with at most a contraction into fused multiply-adds apart
F32_REL = 1e-6
#: a bf16 value that is the rounding of two f32 values 1e-6 apart rounds one
#: step apart where they straddle a rounding boundary
BF16_STEP = 2.0 ** -7
B, S, STEPS = 2, 32, 5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30))


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 step (ulp) at each value of x."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _np(x) -> np.ndarray:
    """A tensor or jax array as an f64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _ref_state(cfg, dtype):
    state, _ = ref_train_step.init_train_state(jax.random.PRNGKey(0), cfg)
    if dtype is not None:
        state["params"] = ref_cast_tree(state["params"], dtype)
    return jax.device_get(state)


def _batches(cfg, n, batch=B, seq=S, seed=0):
    gen = ref_data.SyntheticLM(cfg, ref_data.DataConfig(batch, seq, seed))
    return [b for _, b in zip(range(n), gen.batches())]


def _to_port(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in
            batch.items()}


def _ref_trace(cfg, state, batches, n_microbatches=1):
    step = jax.jit(ref_train_step.make_train_step(
        cfg, ref_opt.AdamWConfig(**OPT), n_microbatches=n_microbatches))
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state), out


def _port_trace(cfg, state, batches, n_microbatches=1):
    step = make_train_step(cfg, optimizer.AdamWConfig(**OPT),
                           n_microbatches=n_microbatches)
    out = []
    for b in batches:
        state, m = step(state, _to_port(b))
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _hold_trace(out, ref, rel=TRACE_REL):
    for i, (o, r) in enumerate(zip(out, ref, strict=True)):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(o[key] - r[key]) <= rel * abs(r[key]), (i, key, o, r)
        assert o["aux_loss"] == r["aux_loss"] == 0.0


# -- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 150])
def test_lr_at_matches_reference(step):
    """Warmup start, inside it, its end, mid-decay, the end and past it."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    ref = ref_opt.lr_at(ref_opt.AdamWConfig(**kw), jnp.asarray(step))
    out = optimizer.lr_at(optimizer.AdamWConfig(**kw), torch.tensor(step))
    assert out.dtype == torch.float32
    assert abs(float(out) - float(ref)) <= F32_REL * float(ref) + 1e-12


def _grad_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((8, 16)).astype(np.float32)
                  * scale},
            "b": (rng.standard_normal(7) * scale).astype(ml_dtypes.bfloat16)}


def _torch_tree(tree):
    return {"a": {"w": torch.from_numpy(tree["a"]["w"].copy())},
            "b": torch.from_numpy(tree["b"].view(np.int16).copy()).view(
                torch.bfloat16)}


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_global_norm_matches_reference(scale):
    """The norm over an f32 and a bf16 leaf together."""
    g = _grad_tree(1, scale)
    ref = float(ref_opt.global_norm(g))
    out = float(optimizer.global_norm(_torch_tree(g)))
    assert abs(out - ref) <= F32_REL * ref


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_adamw_update_matches_reference(moments, scale):
    """Two AdamW steps on identical grads (the second from the first's
    moments), on an f32 and a bf16 param, with f32 and with bf16 moments.
    At scale 1e3 the gradient norm is ~1e4 and is clipped to 1: the
    moments, which hold the clipped gradient, show the clip scale."""
    ref_p = _grad_tree(2)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=4)
    ref_s = ref_opt.init_opt_state(ref_p, jnp.dtype(moments))
    p = _torch_tree(ref_p)
    s = optimizer.init_opt_state(p, getattr(torch, moments))
    for seed in (3, 4):
        g = _grad_tree(seed, scale)
        ref_p, ref_s, ref_info = ref_opt.adamw_update(
            ref_p, g, ref_s, ref_opt.AdamWConfig(**cfg))
        p, s, info = optimizer.adamw_update(
            p, _torch_tree(g), s, optimizer.AdamWConfig(**cfg))
        for key in ("grad_norm", "lr"):
            assert abs(float(info[key]) - float(ref_info[key])) <= (
                F32_REL * float(ref_info[key]))
    assert int(s["step"]) == int(ref_s["step"]) == 2
    assert s["step"].dtype == torch.int32
    for tree, ref in ((p, ref_p), (s["m"], ref_s["m"]), (s["v"], ref_s["v"])):
        for out, r in zip(tree_leaves(tree), jax.tree_util.tree_leaves(ref)):
            assert str(out.dtype).removeprefix("torch.") == str(r.dtype)
            tol = BF16_STEP if out.dtype == torch.bfloat16 else F32_REL
            np.testing.assert_allclose(_np(out), _np(r), rtol=tol,
                                       atol=tol * np.abs(_np(r)).max())


# -- loss ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cross_entropy_matches_reference(dtype):
    """Masked labels (-1) and a padded vocab (columns >= vocab pushed
    down); the loss and its gradient on the logits."""
    rng = np.random.default_rng(5)
    vocab, pv = 300, 512
    logits = (rng.standard_normal((2, 6, pv)) * 3).astype(np.float32)
    logits[..., vocab:] += 50.0   # would win the softmax were they not masked
    labels = rng.integers(0, vocab, (2, 6))
    labels[0, :4] = -1
    ref_logits = jnp.asarray(logits, dtype)
    ref, ref_grad = jax.value_and_grad(
        lambda x: ref_layers.cross_entropy_loss(x, jnp.asarray(labels),
                                                vocab))(ref_logits)
    x = torch.from_numpy(logits).to(getattr(torch, jnp.dtype(dtype).name))
    x.requires_grad_()
    out = cross_entropy_loss(x, torch.from_numpy(labels), vocab)
    out.backward()
    assert out.dtype == torch.float32
    assert abs(out.item() - float(ref)) <= F32_REL * float(ref)
    tol = F32_REL if dtype == jnp.float32 else BF16_STEP
    np.testing.assert_allclose(_np(x.grad), _np(ref_grad), rtol=tol,
                               atol=tol * np.abs(_np(ref_grad)).max())
    assert float(x.grad[..., vocab:].abs().max()) == 0.0


def test_cross_entropy_of_no_valid_label_is_zero():
    labels = torch.full((1, 3), -1)
    assert float(cross_entropy_loss(torch.randn(1, 3, 8), labels, 8)) == 0.0
    ref = ref_layers.cross_entropy_loss(jnp.zeros((1, 3, 8)),
                                        jnp.full((1, 3), -1), 8)
    assert float(ref) == 0.0


def test_embedding_gradient_is_summed_in_f32_as_the_reference():
    """A bf16 table's gradient with every row hit by ~8 tokens: the port's
    lookup sums in f32 and rounds once, as the reference's one-hot
    contraction; each element is then within one bf16 step of the
    reference's (two roundings of f32 sums taken in other orders).
    Indexing's own bf16 backward rounds once per repeat and leaves it."""
    rng = np.random.default_rng(6)
    cfg = get_smoke_config(ARCHS[1])   # ssm: the lookup is not rescaled
    ref_cfg = ref_get_smoke_config(ARCHS[1])
    table = rng.standard_normal((512, 64)).astype(ml_dtypes.bfloat16)
    tokens = rng.integers(0, 512, (8, 512))
    cot = rng.standard_normal((8, 512, 64)).astype(ml_dtypes.bfloat16)
    ref = jax.grad(lambda t: jnp.sum(ref_layers.embed_tokens(
        {"embedding": t}, jnp.asarray(tokens), ref_cfg).astype(jnp.float32)
        * cot.astype(np.float32)))(jnp.asarray(table))
    t = checkpoint.to_tensor(table).requires_grad_()
    out = embed_tokens({"embedding": t}, torch.from_numpy(tokens), cfg)
    out.backward(checkpoint.to_tensor(cot))
    assert t.grad.dtype == torch.bfloat16
    want = _np(ref)
    assert (np.abs(_np(t.grad) - want) <= _bf16_step(want)).all()


# -- data ---------------------------------------------------------------------

def _stub_cfgs(arch="qwen3-0.6b"):
    """(reference, port) smoke configs of ``arch``, and both turned into a
    VLM (patches) and an audio model (frames) for the data pipeline."""
    ref, port = ref_get_smoke_config(arch), get_smoke_config(arch)
    out = [(ref, port)]
    for change in (dict(family="vlm", vision_tokens=16),
                   dict(family="audio", enc_seq=12)):
        out.append((dataclasses.replace(ref, **change),
                    dataclasses.replace(port, **change)))
    return out


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("family", [0, 1, 2], ids=["dense", "vlm", "audio"])
def test_synthetic_lm_is_the_references_bit_for_bit(seed, family):
    ref_cfg, cfg = _stub_cfgs()[family]
    ref = _batches(ref_cfg, 3, batch=3, seq=40, seed=seed)
    gen = data.SyntheticLM(cfg, data.DataConfig(3, 40, seed), device="cpu")
    out = [b for _, b in zip(range(3), gen.batches())]
    for o, r in zip(out, ref):
        assert sorted(o) == sorted(r)
        for key in r:
            want = np.asarray(r[key])
            if want.dtype == ml_dtypes.bfloat16:
                assert o[key].dtype == torch.bfloat16
                got = o[key].view(torch.int16).numpy()
                np.testing.assert_array_equal(got, want.view(np.int16))
            else:
                assert o[key].dtype == torch.int64
                np.testing.assert_array_equal(o[key].numpy(), want)


# -- the train step -----------------------------------------------------------

#: zamba2's random init draws the shared block's wq and wk at
#: 1/sqrt(n_heads) with no qk-norm, so its attention scores run into the
#: hundreds and the softmax is near one-hot.  Its gradient then moves by
#: ~1e-4 under a change of sum order alone: the reference's jitted and
#: eager gradients differ by 1.2e-4 in norm, the port's by 6.6e-4, and
#: both shrink together as the scores do (5-10x at each 3x).  The 5-step
#: trace is held on the same init with wq and wk scaled by this factor,
#: which brings the scores to O(1), as in a trained model; the unscaled
#: first step is held on its own below.
ZAMBA2_QK_SCALE = 0.1


def _trace_state(arch, ref_cfg):
    state = _ref_state(ref_cfg, jnp.float32)
    if arch == "zamba2-7b":
        shared = state["params"]["shared_attn"]
        for key in ("wq", "wk"):
            shared[key] = shared[key] * np.float32(ZAMBA2_QK_SCALE)
    return state


@pytest.fixture(scope="module")
def f32_traces():
    """Per arch: the reference's 5-step f32 trace, and the port's from the
    same initial state and batches."""
    out = {}
    for arch in ARCHS:
        ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
        ref_state = _trace_state(arch, ref_cfg)
        batches = _batches(ref_cfg, STEPS)
        _, ref = _ref_trace(ref_cfg, ref_state, batches)
        state = state_from_numpy(ref_state, cfg)
        _, got = _port_trace(cfg, state, batches)
        out[arch] = got, ref
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_five_step_trace_matches_reference(f32_traces, arch):
    out, ref = f32_traces[arch]
    _hold_trace(out, ref)


#: the unscaled zamba2's first step: the loss is a forward and holds to
#: TRACE_REL; its gradient norm is held to ten times the reference's own
#: jit-vs-eager distance (see ZAMBA2_QK_SCALE)
ZAMBA2_RAW_GRAD_REL = 1e-3


def test_f32_first_step_of_the_random_zamba2_matches_reference():
    ref_cfg, cfg = ref_get_smoke_config("zamba2-7b"), get_smoke_config(
        "zamba2-7b")
    ref_state = _ref_state(ref_cfg, jnp.float32)
    batches = _batches(ref_cfg, 1)
    _, (ref,) = _ref_trace(ref_cfg, ref_state, batches)
    _, (out,) = _port_trace(cfg, state_from_numpy(ref_state, cfg), batches)
    assert abs(out["loss"] - ref["loss"]) <= TRACE_REL * ref["loss"]
    assert abs(out["grad_norm"] - ref["grad_norm"]) <= (
        ZAMBA2_RAW_GRAD_REL * ref["grad_norm"])


def test_state_from_numpy_carries_the_reference_state():
    ref_cfg, cfg = ref_get_smoke_config(ARCHS[0]), get_smoke_config(ARCHS[0])
    ref_state = _ref_state(ref_cfg, None)
    state = state_from_numpy(ref_state, cfg)
    params = tree_leaves(state["params"])
    assert all(p.requires_grad and p.dtype == torch.bfloat16 for p in params)
    moments = tree_leaves([state["opt"]["m"], state["opt"]["v"]])
    assert all(m.dtype == torch.float32 and not m.requires_grad
               for m in moments)
    step = state["opt"]["step"]
    assert step.shape == () and step.dtype == torch.int32
    ref_params = registry.init_params(None, cfg, device="meta")[0]
    assert [p.shape for p in params] == [p.shape for p in
                                         tree_leaves(ref_params)]


#: one bf16 step of qwen3 smoke: loss and grad norm are f32 reductions of
#: bf16 activations that the two packages round at other points (XLA fuses
#: and rounds where eager PyTorch rounds elsewhere); each lies ~5e-5 from
#: the same step on f32 weights, and they lie ~1e-4 apart
BF16_SCALAR_REL = 1e-3
#: share of bf16 params that may end more than one bf16 step from the
#: reference's after the step (measured at most 0.25% of a leaf)
BF16_OFF_SHARE = 5e-3


@pytest.fixture(scope="module")
def bf16_step():
    ref_cfg, cfg = ref_get_smoke_config(ARCHS[0]), get_smoke_config(ARCHS[0])
    ref_state = _ref_state(ref_cfg, None)
    batches = _batches(ref_cfg, 1, batch=4, seq=64)
    ref_after, ref = _ref_trace(ref_cfg, ref_state, batches)
    state = state_from_numpy(ref_state, cfg)
    after, out = _port_trace(cfg, state, batches)
    return out, ref, after, ref_after


def test_bf16_step_matches_reference(bf16_step):
    out, ref, _, _ = bf16_step
    _hold_trace(out, ref, BF16_SCALAR_REL)


def test_bf16_step_updates_params_as_reference(bf16_step):
    """The updated bf16 params.  A first AdamW step moves each param by
    lr * g / (|g| + eps), ±lr where the gradient is not tiny; where bf16
    noise flips the sign of a near-zero gradient the two packages move it
    2 lr apart.  So every param is within 2 lr and one bf16 step of the
    reference's, and all but a few within one bf16 step."""
    out, _, after, ref_after = bf16_step
    lr = out[0]["lr"]
    ref_flat = ref_checkpoint._flatten(ref_after["params"])
    for key, p in checkpoint.flatten(after["params"]).items():
        want = _np(ref_flat[key])
        err = np.abs(_np(p) - want)
        assert (err <= 2 * lr + _bf16_step(want)).all(), key
        assert (err > _bf16_step(want)).mean() < BF16_OFF_SHARE, key


@pytest.fixture(scope="module")
def microbatch_traces():
    arch = ARCHS[0]
    ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    ref_state = _ref_state(ref_cfg, jnp.float32)
    batches = _batches(ref_cfg, 2, batch=8)
    _, ref4 = _ref_trace(ref_cfg, ref_state, batches, n_microbatches=4)
    _, out1 = _port_trace(cfg, state_from_numpy(ref_state, cfg), batches)
    _, out4 = _port_trace(cfg, state_from_numpy(ref_state, cfg), batches,
                          n_microbatches=4)
    return out1, out4, ref4


def test_microbatches_equal_one_batch(microbatch_traces):
    """k=4 against k=1 in the port (rel 1e-4, as the reference's
    tests/test_training_serving.py::test_microbatch_equivalence)."""
    out1, out4, _ = microbatch_traces
    _hold_trace(out4, out1)


def test_microbatches_match_reference(microbatch_traces):
    _, out4, ref4 = microbatch_traces
    _hold_trace(out4, ref4)


def test_microbatches_must_divide_the_batch():
    cfg = get_smoke_config(ARCHS[0])
    state = init_train_state(None, cfg, device="meta")
    batch = {"tokens": torch.zeros((6, 8), dtype=torch.int64),
             "labels": torch.zeros((6, 8), dtype=torch.int64)}
    with pytest.raises(ValueError, match="multiple of 4"):
        make_train_step(cfg, n_microbatches=4)(state, batch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_layers_are_checkpointed_only_under_grad(monkeypatch, arch):
    """Every layer (and each shared-block application of the hybrid) runs
    under activation checkpointing while autograd records, and none does
    without grad; the logits are the same bits either way."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = registry.init_params(gen, cfg)[0]
    calls = []
    real = transformer.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(kwargs)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(transformer, "checkpoint", spy)
    tok = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))}
    with torch.no_grad():
        plain = registry.forward(params, cfg, tok).logits
    assert calls == []
    remat = registry.forward(params, cfg, tok).logits
    n_blocks = cfg.n_layers + (cfg.n_layers // cfg.attn_every
                               if cfg.family == "hybrid" else 0)
    assert len(calls) == n_blocks
    assert all(c["use_reentrant"] is False for c in calls)
    assert torch.equal(plain, remat)


# -- the kernels refuse autograd (the reference's pallas_call has no VJP) -----

def _flash_inputs(dtype=torch.float32):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((1, 2, 64, 32),
                                                 dtype=np.float32)).to(dtype)
            for _ in range(3)]


def _ssd_inputs():
    rng = np.random.default_rng(0)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return [rnd(1, 64, 2, 16), rnd(1, 64, 2).abs(), -rnd(2).abs(),
            rnd(1, 64, 8), rnd(1, 64, 8)]


@pytest.mark.parametrize("which", range(3))
def test_flash_attention_refuses_inputs_that_require_grad(which):
    args = _flash_inputs()
    args[which].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(*args)
    with torch.no_grad():   # no graph is recorded: the call runs
        out = flash_attention(*args)
    assert out.shape == args[0].shape and not out.requires_grad


@pytest.mark.parametrize("which", range(5))
def test_ssd_scan_refuses_inputs_that_require_grad(which):
    args = _ssd_inputs()
    args[which].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(*args, chunk=32)
    with torch.inference_mode():
        y, state = ssd_scan(*args, chunk=32)
    assert y.shape == args[0].shape and state.shape == (1, 2, 16, 8)


def test_dense_training_on_pallas_raises_where_the_reference_trains():
    """A known divergence: the reference's dense forward takes XLA
    attention even at attn_impl="pallas" (its per-layer window is traced),
    so its loss differentiates; the port's dense forward sends "pallas" to
    the flash kernel, which refuses autograd."""
    ref_cfg = dataclasses.replace(ref_get_smoke_config(ARCHS[0]),
                                  attn_impl="pallas")
    cfg = dataclasses.replace(get_smoke_config(ARCHS[0]), attn_impl="pallas")
    ref_state = _ref_state(ref_cfg, jnp.float32)
    batch = _batches(ref_cfg, 1, seq=64)[0]
    grads = jax.grad(lambda p: ref_registry.loss_fn(p, ref_cfg, batch)[0])(
        ref_state["params"])
    assert float(ref_opt.global_norm(grads)) > 0
    params = state_from_numpy(ref_state, cfg)["params"]
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        registry.loss_fn(params, cfg, _to_port(batch))
    with torch.no_grad():    # the same forward without grad runs
        registry.loss_fn(params, cfg, _to_port(batch))


def test_ssm_training_on_pallas_raises():
    cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                              ssm_impl="pallas")
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    batch = _to_port(_batches(ref_get_smoke_config("mamba2-2.7b"), 1)[0])
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        make_train_step(cfg)(state, batch)


# -- checkpoints cross both ways ----------------------------------------------

@pytest.fixture(scope="module")
def trained_states():
    """The reference's bf16 qwen3 smoke state after one step, and the
    port's after one step (params bf16, moments f32, step 1)."""
    ref_cfg, cfg = ref_get_smoke_config(ARCHS[0]), get_smoke_config(ARCHS[0])
    ref_state = _ref_state(ref_cfg, None)
    batches = _batches(ref_cfg, 1)
    ref_after, _ = _ref_trace(ref_cfg, ref_state, batches)
    after, _ = _port_trace(cfg, state_from_numpy(ref_state, cfg), batches)
    return ref_after, after


def _same_flat(port_state, ref_state):
    ref_flat = ref_checkpoint._flatten(ref_state)
    flat = checkpoint.flatten(port_state)
    assert sorted(flat) == sorted(ref_flat)
    for key, t in flat.items():
        want = ref_flat[key]
        assert checkpoint.dtype_name(t.dtype) == str(want.dtype), key
        np.testing.assert_array_equal(checkpoint.to_numpy(t),
                                      checkpoint.to_numpy(
                                          checkpoint.to_tensor(want)))


def test_reference_checkpoint_loads_in_the_port(tmp_path, trained_states):
    ref_after, _ = trained_states
    path = str(tmp_path / "ref.npz")
    ref_checkpoint.save_checkpoint(path, ref_after, step=1)
    cfg = get_smoke_config(ARCHS[0])
    skeleton = init_train_state(None, cfg, device="meta")
    state = checkpoint.load_checkpoint(path, skeleton, device="cpu")
    _same_flat(state, ref_after)
    assert all(p.requires_grad for p in tree_leaves(state["params"]))
    assert state["opt"]["step"].dtype == torch.int32
    assert checkpoint.read_checkpoint(path)[2] == 1
    # serving reads the params of the same file through the same module
    params = params_from_numpy(ref_after["params"], cfg)
    for a, b in zip(tree_leaves(load_npz_params(path, cfg)),
                    tree_leaves(params)):
        assert torch.equal(a, b)


def test_port_checkpoint_loads_in_the_reference(tmp_path, trained_states):
    _, after = trained_states
    path = str(tmp_path / "port")
    checkpoint.save_checkpoint(path, after, step=1)
    assert (tmp_path / "port.npz").exists()
    skeleton, _ = ref_train_step.init_train_state(
        jax.random.PRNGKey(1), ref_get_smoke_config(ARCHS[0]))
    ref_state = ref_checkpoint.load_checkpoint(path, jax.device_get(skeleton))
    _same_flat(after, ref_state)
    # and the reference trains on from it
    ref_cfg = ref_get_smoke_config(ARCHS[0])
    _, trace = _ref_trace(ref_cfg, ref_state, _batches(ref_cfg, 1, seed=1))
    assert np.isfinite(trace[0]["loss"])


def test_checkpoint_refuses_a_state_of_another_shape(tmp_path,
                                                     trained_states):
    _, after = trained_states
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, after)
    other = init_train_state(
        None, dataclasses.replace(get_smoke_config(ARCHS[0]), d_ff=256),
        device="meta")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_checkpoint(path, other, device="cpu")


# -- the trainer --------------------------------------------------------------

def _train(*args, timeout=120):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--smoke", "--batch", "2", "--seq", "32", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def test_train_cli_checkpoints_and_resumes(tmp_path):
    run = _train("--device", "cpu", "--steps", "2", "--log-every", "1",
                 "--ckpt", str(tmp_path / "run"), "--ckpt-every", "1")
    assert run.returncode == 0, run.stderr
    steps = [ln for ln in run.stdout.splitlines() if ln.startswith("step")]
    assert len(steps) == 2 and all("tok/s" in ln for ln in steps)
    for name in ("run.step1.npz", "run.step2.npz", "run.final.npz"):
        assert (tmp_path / name).exists()
    final = str(tmp_path / "run.final.npz")
    assert checkpoint.read_checkpoint(final)[2] == 2
    resumed = _train("--device", "cpu", "--steps", "1", "--resume", final,
                     "--ckpt", str(tmp_path / "again"))
    assert resumed.returncode == 0, resumed.stderr
    assert f"resumed from {final}" in resumed.stdout
    flat, _, _ = checkpoint.read_checkpoint(str(tmp_path /
                                                "again.final.npz"))
    assert int(flat["opt/step"]) == 3   # the resumed counter went on


def test_train_cli_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    run = _train("--steps", "1", timeout=60)
    assert run.returncode != 0
    assert "torch.cuda.is_available() is False" in run.stderr
    assert "step" not in run.stdout
