"""The port's CUDA kernels on the card, against their plain versions, and
the multi-tenant flow's memory-cap leases.

These tests need an NVIDIA GPU and skip without one; the module imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ops import flash_mha, ssd_mixer
from repro_torch.kernels.ref import attention_ref, ssd_ref
from repro_torch.models import registry, transformer
from repro_torch.models.module import cast_tree, tree_map

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # test_kernels.py:99,123


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda")


def _bhsd(x):
    return x.transpose(1, 2)


def _route_counts():
    return dict(fa.launches_by_route)


def _moved(before):
    return {r: fa.launches_by_route[r] - before[r] for r in before}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 256, 8, 4, 128, True, None), (1, 200, 4, 1, 64, True, 64),
    (1, 200, 2, 2, 64, False, None), (1, 128, 2, 2, 32, True, 32),
    (1, 128, 2, 1, 256, True, None), (2, 256, 4, 4, 112, True, None),
    (1, 200, 2, 2, 112, True, None)])
def test_kernel_matches_plain(card, dtype, b, s, h, kh, d, causal, window):
    rng = np.random.default_rng(s + h + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d),
                                                    dtype=np.float32))
               .to(card, dtype) for n in (h, kh, kh))
    before, by_route = fa.launches, _route_counts()
    out = flash_mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    # f32 at any D, and bf16 at D 32, go to the CUDA-core kernel
    sm90 = dtype == torch.bfloat16 and d in (64, 112, 128, 256)
    assert _moved(by_route) == {"sm90": int(sm90), "simt": int(not sm90)}
    ref = _bhsd(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                              window=window))
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# (b, s, h, kh, d, causal, window): the bf16 wgmma kernel's cases, D 64,
# 112 (on the 128-column code, the last 16 columns zero-filled) and 128,
# GQA groups of 1, 2 and 8, causal, windows of 64 and 128, non-causal
# ragged (the pad hidden by kv_len), S of 64, 200 (padded), 512 and 1024;
# zamba2's prefill shape (MHA at D=112: one head over two q tiles a block);
# D=256 (one block an SM): gemma-2b's prefill shape (MQA, KH=1), ragged S,
# a window, an odd group (one head over two q tiles), S=1024, non-causal;
# the MoE configs' GQA groups: grok-1's 48 heads over 8 KV heads (group 6,
# two heads a block) and llama4-maverick's 40 over 8 (group 5, one head
# over two q tiles, K/V head h // 5), at their prefill shape and ragged
SM90_CASES = [
    (2, 512, 16, 8, 128, True, None), (1, 64, 2, 2, 64, True, None),
    (1, 200, 8, 1, 128, True, None), (2, 512, 4, 4, 64, True, 64),
    (1, 1024, 8, 1, 64, True, 128), (2, 200, 4, 2, 128, False, None),
    (1, 200, 2, 2, 64, False, None), (1, 1024, 16, 2, 128, True, None),
    (1, 512, 8, 8, 128, True, 128), (2, 64, 16, 2, 64, False, None),
    (8, 512, 32, 32, 112, True, None), (1, 200, 4, 4, 112, True, None),
    (2, 200, 4, 2, 112, False, None), (1, 512, 4, 4, 112, True, 128),
    (8, 512, 8, 1, 256, True, None), (2, 200, 8, 1, 256, True, None),
    (2, 512, 8, 1, 256, True, 128), (1, 512, 3, 1, 256, True, None),
    (1, 1024, 8, 1, 256, True, None), (1, 200, 4, 2, 256, False, None),
    (8, 512, 48, 8, 128, True, None), (2, 200, 48, 8, 128, True, None),
    (8, 512, 40, 8, 128, True, None), (2, 200, 40, 8, 128, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", SM90_CASES)
def test_sm90_kernel_matches_plain(card, b, s, h, kh, d, causal, window):
    """The bf16 wgmma kernel against the plain version, on model-layout
    inputs that reach it as transposed views (no copies)."""
    rng = np.random.default_rng(3 * s + h + d + kh)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d),
                                                    dtype=np.float32))
               .to(card, torch.bfloat16) for n in (h, kh, kh))
    before = _route_counts()
    out = flash_mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _moved(before) == {"sm90": 1, "simt": 0}
    assert out.shape == (b, s, h, d) and out.dtype == torch.bfloat16
    ref = _bhsd(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                              window=window))
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_prefill_on_kernel_matches_plain_path(card):
    """Smoke config, f32 weights: the prefill through the kernel (one
    launch per layer) against the plain attention path."""
    cfg = get_smoke_config("qwen3-0.6b")
    gen = torch.Generator(device=card).manual_seed(0)
    params = cast_tree(registry.init_params(gen, cfg)[0], torch.float32)
    tokens = registry.make_dummy_batch(cfg, 3, 100, seed=1,
                                       device=card)["tokens"]
    out = {}
    with torch.inference_mode():
        for impl in ("xla", "pallas"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            caches = registry.init_caches(c, 3, 128, card)
            before = fa.launches
            out[impl], caches = transformer.prefill(params, c, tokens, caches)
            assert fa.launches - before == (cfg.n_layers if impl == "pallas"
                                            else 0)
    # both paths in f32, summed in other orders; measured against the
    # largest logit, as the CPU tests hold prefill to the reference
    err = (out["pallas"] - out["xla"]).abs().max() / out["xla"].abs().max()
    assert float(err) < 1e-4, float(err)


@pytest.mark.cuda
def test_bf16_prefill_on_sm90_kernel_matches_plain_path(card):
    """Smoke config, bf16 weights (head dim 64, two query heads a KV head):
    the prefill makes one sm90 launch a layer and its last logits stay
    within 5e-2 of the plain path's, relative to the largest logit, as
    chip_smoke.py holds qwen3-0.6b at full width."""
    cfg = get_smoke_config("qwen3-0.6b")
    gen = torch.Generator(device=card).manual_seed(0)
    params = registry.init_params(gen, cfg)[0]
    tokens = registry.make_dummy_batch(cfg, 3, 128, seed=1,
                                       device=card)["tokens"]
    out = {}
    with torch.inference_mode():
        for impl in ("xla", "pallas"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            caches = registry.init_caches(c, 3, 256, card)
            before = _route_counts()
            out[impl], _ = transformer.prefill(params, c, tokens, caches)
            want = cfg.n_layers if impl == "pallas" else 0
            assert _moved(before) == {"sm90": want, "simt": 0}
    assert bool(torch.isfinite(out["pallas"]).all())
    err = ((out["pallas"].float() - out["xla"].float()).abs().max()
           / out["xla"].float().abs().max())
    assert float(err) < 5e-2, float(err)


def _ssd_inputs(card, dtype, b, s, h, p, n, seed):
    """The reference tests' SSD inputs (tests/test_kernels.py:81-90), drawn
    with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.2)
    bc = [rng.standard_normal((b, s, n), dtype=np.float32) * 0.3
          for _ in range(2)]
    return (torch.from_numpy(x).to(card, dtype),
            *(torch.from_numpy(t).to(card) for t in (dt, a, *bc)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 512, 4, 64, 128, 256), (1, 200, 3, 64, 128, 256),
    (1, 512, 2, 64, 128, 64), (1, 100, 2, 64, 128, 256),
    (2, 128, 1, 64, 128, 256), (1, 128, 2, 128, 16, 32),
    (1, 96, 2, 16, 8, 32), (1, 256, 2, 32, 100, 128),
    (2, 512, 4, 64, 64, 256), (1, 200, 3, 64, 64, 64)])
def test_ssd_kernel_matches_plain(card, dtype, b, s, h, p, n, chunk):
    """y and the final state of the kernel against the sequential plain
    version, on the same inputs (padded S, partial chunks, P and N of the
    serving and smoke configs)."""
    args = _ssd_inputs(card, dtype, b, s, h, p, n, s + h + p + n)
    before, by_route = ssd.launches, dict(ssd.launches_by_route)
    y, state = ssd_mixer(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    # the routing table itself is held in tests/test_torch_ssd_route.py
    want = ssd.route(dtype, p, n, chunk)
    assert {r: ssd.launches_by_route[r] - by_route[r] for r in by_route} == {
        r: int(r == want) for r in ssd.ROUTES}
    y_ref, state_ref = ssd_ref(*args)
    assert y.dtype == dtype and y.shape == (b, s, h, p)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=SSD_TOL[dtype],
                               rtol=SSD_TOL[dtype])
    torch.testing.assert_close(state, state_ref, atol=2e-4, rtol=2e-4)


# (b, s, h, chunk): the bf16 wgmma kernel's cases at P=64, N=128: chunks
# of 64, 128 and 256, one head (a block of one warpgroup) and odd H, ragged
# S (padded by the adapter), one 64-row step, and 16 steps
SM90_SSD_CASES = [
    (2, 512, 4, 64), (2, 512, 4, 128), (1, 256, 6, 256), (2, 512, 1, 256),
    (2, 200, 2, 128), (1, 100, 3, 256), (3, 64, 2, 64), (1, 1024, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,chunk", SM90_SSD_CASES)
def test_sm90_ssd_kernel_matches_plain(card, b, s, h, chunk):
    args = _ssd_inputs(card, torch.bfloat16, b, s, h, 64, 128,
                       7 * s + h + chunk)
    before = dict(ssd.launches_by_route)
    y, state = ssd_mixer(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert {r: ssd.launches_by_route[r] - before[r] for r in before} == {
        "sm90": 1, "simt": 0}
    y_ref, state_ref = ssd_ref(*args)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, 64)
    tol = SSD_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_ref, atol=2e-4, rtol=2e-4)


# (b, s, h, chunk): the sm90 route at N=64 (B and C zero-padded to the
# kernel's 128, the state cut back): zamba2's prefill shape, chunk 64, odd
# H, ragged S
SM90_SSD_N64_CASES = [(8, 512, 112, 256), (2, 512, 4, 64), (1, 256, 3, 128),
                      (2, 200, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,chunk", SM90_SSD_N64_CASES)
def test_sm90_ssd_kernel_at_state_64_matches_plain(card, b, s, h, chunk):
    args = _ssd_inputs(card, torch.bfloat16, b, s, h, 64, 64,
                       5 * s + h + chunk)
    before = dict(ssd.launches_by_route)
    y, state = ssd_mixer(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert {r: ssd.launches_by_route[r] - before[r] for r in before} == {
        "sm90": 1, "simt": 0}
    y_ref, state_ref = ssd_ref(*args)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, 64)
    assert state.shape == (b, h, 64, 64) and state.is_contiguous()
    tol = SSD_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_ref, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_bf16_hybrid_prefill_on_sm90_kernels_matches_plain_path(card):
    """zamba2's smoke config at zamba2's own head dims (MHA at D=112, P=64,
    N=64, chunk 64; 5 layers, a shared block after every 2), bf16 weights:
    the prefill makes one sm90 flash launch per shared-block application
    and one sm90 SSD launch per Mamba2 layer, none on simt, and its last
    logits stay within 5e-2 of the plain path's (relative to the largest
    logit).  With qk-norm: without it the random init's scores are in the
    hundreds, where the plain path (like the reference's) rounds q k^T to
    bf16 steps of ~1 before the softmax, and so is no measure of the
    kernel (chip_smoke.py holds zamba2's own blocks one by one)."""
    cfg = dataclasses.replace(
        get_smoke_config("zamba2-7b"), n_layers=5, attn_every=2,
        d_model=224, n_heads=2, n_kv_heads=2, head_dim=112, d_ff=448,
        ssm_heads=7, ssm_state=64, ssm_chunk=64, qk_norm=True)
    gen = torch.Generator(device=card).manual_seed(0)
    params = registry.init_params(gen, cfg)[0]
    tokens = registry.make_dummy_batch(cfg, 3, 200, seed=1,
                                       device=card)["tokens"]
    out = {}
    with torch.inference_mode():
        for impl in ("xla", "pallas"):
            c = dataclasses.replace(cfg, attn_impl=impl, ssm_impl=impl)
            caches = registry.init_caches(c, 3, 256, card)
            fa_before = _route_counts()
            ssd_before = dict(ssd.launches_by_route)
            out[impl], _ = registry.prefill_caches(params, c, tokens, caches)
            on = impl == "pallas"
            assert _moved(fa_before) == {"sm90": 2 * on, "simt": 0}
            assert {r: ssd.launches_by_route[r] - ssd_before[r]
                    for r in ssd_before} == {"sm90": 5 * on, "simt": 0}
    assert bool(torch.isfinite(out["pallas"]).all())
    err = ((out["pallas"].float() - out["xla"].float()).abs().max()
           / out["xla"].float().abs().max())
    assert float(err) < 5e-2, float(err)


@pytest.mark.cuda
def test_bf16_ssm_prefill_on_sm90_kernel_matches_plain_path(card):
    """mamba2's smoke config widened to the wgmma kernel's shapes (8 heads
    of P=64, N=128, chunk 64), bf16 weights: the prefill makes one sm90
    launch a layer, and its last logits and state cache stay within 5e-2
    of the plain chunked SSD's (relative to the largest value)."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                              ssm_state=128, ssm_heads=8, ssm_chunk=64)
    gen = torch.Generator(device=card).manual_seed(0)
    params = registry.init_params(gen, cfg)[0]
    tokens = registry.make_dummy_batch(cfg, 3, 200, seed=1,
                                       device=card)["tokens"]
    out, caches = {}, {}
    with torch.inference_mode():
        for impl in ("xla", "pallas"):
            c = dataclasses.replace(cfg, ssm_impl=impl)
            caches[impl] = registry.init_caches(c, 3, 256, card)
            before = dict(ssd.launches_by_route)
            out[impl], _ = registry.prefill_caches(params, c, tokens,
                                                   caches[impl])
            want = cfg.n_layers if impl == "pallas" else 0
            assert {r: ssd.launches_by_route[r] - before[r]
                    for r in before} == {"sm90": want, "simt": 0}
    assert bool(torch.isfinite(out["pallas"]).all())
    err = ((out["pallas"].float() - out["xla"].float()).abs().max()
           / out["xla"].float().abs().max())
    assert float(err) < 5e-2, float(err)
    want = caches["xla"]["ssm"]["state"]
    got = caches["pallas"]["ssm"]["state"]
    assert float((got - want).abs().max() / want.abs().max()) < 5e-2


@pytest.mark.cuda
def test_ssm_prefill_on_kernel_matches_plain_path(card):
    """mamba2's smoke config, f32 weights: the cache-filling prefill through
    the SSD kernel (one launch per layer) against the plain chunked SSD."""
    cfg = get_smoke_config("mamba2-2.7b")
    gen = torch.Generator(device=card).manual_seed(0)
    params = cast_tree(registry.init_params(gen, cfg)[0], torch.float32)
    tokens = registry.make_dummy_batch(cfg, 3, 100, seed=1,
                                       device=card)["tokens"]
    out, caches = {}, {}
    with torch.inference_mode():
        for impl in ("xla", "pallas"):
            c = dataclasses.replace(cfg, ssm_impl=impl)
            caches[impl] = registry.init_caches(c, 3, 128, card)
            before = ssd.launches
            out[impl], _ = registry.prefill_caches(params, c, tokens,
                                                   caches[impl])
            assert ssd.launches - before == (cfg.n_layers if impl == "pallas"
                                             else 0)
    err = (out["pallas"] - out["xla"]).abs().max() / out["xla"].abs().max()
    assert float(err) < 1e-4, float(err)
    for name in ("conv", "state"):
        want = caches["xla"]["ssm"][name]
        got = caches["pallas"]["ssm"][name]
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4


# -- training: the kernels refuse autograd; the plain path trains on the card -

#: (kernel, route, input dtype) of each refusal case: every route of both
#: kernels
REFUSALS = [("flash", "sm90", torch.bfloat16), ("flash", "simt",
                                                torch.float32),
            ("ssd", "sm90", torch.bfloat16), ("ssd", "simt", torch.float32)]


def _kernel_call(kernel, dtype, card):
    """(call, inputs, module) of one small kernel call on the card."""
    gen = torch.Generator(device=card).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card)
    if kernel == "flash":
        args = [rnd(1, 2, 64, 128).to(dtype) for _ in range(3)]
        return lambda: fa.flash_attention(*args), args, fa
    args = [rnd(1, 64, 2, 64).to(dtype), rnd(1, 64, 2).abs(),
            -rnd(2).abs(), rnd(1, 64, 128), rnd(1, 64, 128)]
    return lambda: ssd.ssd_scan(*args, chunk=64), args, ssd


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,route,dtype", REFUSALS)
def test_kernel_refuses_inputs_that_require_grad(card, kernel, route, dtype):
    """On every route an input that requires grad raises before the
    launch; without grad the same call launches on that route."""
    call, args, mod = _kernel_call(kernel, dtype, card)
    args[0].requires_grad_()
    before = dict(mod.launches_by_route)
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert mod.launches_by_route == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert {r: mod.launches_by_route[r] - before[r] for r in before} == {
        r: int(r == route) for r in mod.ROUTES}


@pytest.mark.cuda
def test_f32_smoke_train_step_on_card_matches_cpu(card):
    """One f32 step of qwen3's smoke config from one initial state on the
    card and on the CPU: loss and grad norm within 1e-4, no kernel
    launched."""
    from repro_torch.models.module import tree_map
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import make_train_step
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config("qwen3-0.6b")
    params = cast_tree(registry.init_params(
        torch.Generator().manual_seed(0), cfg)[0], torch.float32)
    metrics = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(),
                     params)
        batch = next(SyntheticLM(cfg, DataConfig(2, 64), dev).batches())
        launches = (fa.launches, ssd.launches)
        _, m = make_train_step(cfg)({"params": p, "opt": init_opt_state(p)},
                                    batch)
        metrics[dev] = {k: float(v) for k, v in m.items()}
        assert (fa.launches, ssd.launches) == launches
    for key in ("loss", "grad_norm"):
        assert abs(metrics["cuda"][key] - metrics["cpu"][key]) <= (
            1e-4 * abs(metrics["cpu"][key])), (key, metrics)


#: whisper's random init is chaotic (scores in the hundreds, no qk-norm):
#: one f32 step on its frames moves its logits by over 5e-3 at two layers
#: (tests/test_torch_encdec.py).  Card-vs-CPU comparisons scale every
#: attention's wq and wk by this factor, which brings the scores to O(1)
WHISPER_QK_SCALE = 0.1


def _whisper_smoke(dtype):
    """whisper's smoke config (GQA 4:2 at head dim 64) and its params on
    the CPU in ``dtype``, wq and wk scaled by WHISPER_QK_SCALE."""
    cfg = get_smoke_config("whisper-medium")
    params = cast_tree(registry.init_params(
        torch.Generator().manual_seed(0), cfg)[0], dtype)
    for stack in ("encoder", "decoder", "cross"):
        for key in ("wq", "wk"):
            params[stack][key] = params[stack][key] * WHISPER_QK_SCALE
    return cfg, params


@pytest.mark.cuda
def test_whisper_prefill_on_card_matches_cpu(card):
    """Smoke config, f32 weights and frames, f32 caches: the encoder
    prefill and the decoder prefill on the card, the decoder's self
    attention on the simt kernel (one launch a layer), against the same
    calls on the CPU (the kernel's plain version): self and cross caches
    and last logits within 1e-4 of their largest entry."""
    from repro_torch.models.module import tree_map
    cfg, params = _whisper_smoke(torch.float32)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    batch = registry.make_dummy_batch(cfg, 3, 100, seed=1)
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            caches = cast_tree(registry.init_caches(cfg, 3, 128, dev),
                               torch.float32)
            before = _route_counts()
            registry.prefill_encoder(
                p, cfg, {"frames": batch["frames"].to(dev, torch.float32)},
                caches)
            logits, caches = registry.prefill_caches(
                p, cfg, batch["tokens"].to(dev), caches)
            want = cfg.n_layers if dev == "cuda" else 0
            assert _moved(before) == {"sm90": 0, "simt": want}
            out[dev] = {"logits": logits, **caches}
    for name, ref in out["cpu"].items():
        got = out["cuda"][name].cpu()
        err = (got - ref).abs().max() / ref.abs().max()
        assert float(err) < 1e-4, (name, float(err))


@pytest.mark.cuda
def test_whisper_bf16_serving_launches_flash_on_sm90(card):
    """Smoke config, bf16 weights (wq and wk scaled): ServeEngine.run makes
    one sm90 flash launch per decoder layer in its prefill, none on simt
    and no SSD launch; the encoder and the cross attention stay plain.  The
    prefill's last logits stay within 5e-2 of the plain path's."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.module import tree_map
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    cfg, params = _whisper_smoke(torch.bfloat16)
    params = tree_map(lambda t: t.to(card), params)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    reqs = make_requests(cfg, 3, 100, 8, 0)
    before, ssd_before = _route_counts(), ssd.launches
    out = ServeEngine(cfg, params, EngineConfig(max_batch=3, max_context=128,
                                                predict=False),
                      device=card).run(reqs)
    assert _moved(before) == {"sm90": cfg.n_layers, "simt": 0}
    assert ssd.launches == ssd_before
    assert all(len(r.generated) == 8 and 0 <= min(r.generated)
               and max(r.generated) < cfg.vocab for r in out)
    frames = torch.zeros((3, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                         device=card)
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(card)
    logits = {}
    with torch.inference_mode():
        for impl in ("xla", "pallas"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            caches = registry.init_caches(c, 3, 128, card)
            registry.prefill_encoder(params, c, {"frames": frames}, caches)
            logits[impl], _ = registry.prefill_caches(params, c, tokens,
                                                      caches)
    err = ((logits["pallas"].float() - logits["xla"].float()).abs().max()
           / logits["xla"].float().abs().max())
    assert float(err) < 5e-2, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_moe_tokens_on_card_matches_cpu(card, arch):
    """One bf16 MoE layer of the smoke config (grok's top-2, llama4's
    top-1 over 4 experts) on 3 x 100 tokens: moe_tokens on the card routes
    every token as on the CPU, and its output is within 2e-2 of the CPU's
    (relative to the largest entry: bf16 products summed in other
    orders)."""
    from repro_torch.models import moe
    from repro_torch.models.module import tree_map
    cfg = get_smoke_config(arch)
    params = cast_tree(registry.init_params(
        torch.Generator().manual_seed(0), cfg)[0], torch.bfloat16)
    stack = "layers" if cfg.moe_every == 1 else "moe_layers"
    lp = {k: v[0] for k, v in params[stack].items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 100, cfg.d_model), dtype=np.float32)).bfloat16()
    out, routes = {}, {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), lp)
            out[dev] = moe.moe_tokens(p, x.to(dev), cfg).float().cpu()
            routes[dev] = moe.top_k_routes(p, x.to(dev), cfg)[1].cpu()
    torch.testing.assert_close(routes["cuda"], routes["cpu"], rtol=0, atol=0)
    err = (out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()
    assert float(err) < 2e-2, float(err)


@pytest.mark.cuda
def test_memory_lease_caps_the_allocator_and_lifts_the_cap(card):
    from repro_torch.launch.multi_tenant import memory_lease
    gib = 1024 ** 3
    with memory_lease(card, 1.0):
        kept = torch.empty(gib // 2, dtype=torch.uint8, device=card)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            torch.empty(gib, dtype=torch.uint8, device=card)
        assert torch.cuda.max_memory_allocated(card) <= gib
    with pytest.raises(KeyError):
        with memory_lease(card, 1.0):
            raise KeyError("the cap is lifted on the way out")
    del kept
    assert torch.empty(2 * gib, dtype=torch.uint8, device=card).numel()


@pytest.mark.cuda
def test_multi_tenant_flow_on_card_matches_cpu(card):
    """The smoke flow's leases and tokens on the card and on the CPU, on the
    same f32 weights (the tied embedding scaled down, so that the layers
    pick the tokens rather than token 0 repeating itself)."""
    from repro_torch.launch import multi_tenant as mt
    cfg = get_smoke_config("qwen3-0.6b")
    gen = torch.Generator().manual_seed(0)
    params = cast_tree(registry.init_params(gen, cfg)[0], torch.float32)
    params["embedding"] = params["embedding"] * 0.05
    runs = {}
    for dev in ("cpu", card):
        p = tree_map(lambda x: x.to(dev), params)
        before = (fa.launches, ssd.launches)
        pm, tenants = mt.run_tenants(cfg, p, mt.make_jobs(smoke=True), dev,
                                     log=lambda line: None)
        assert (fa.launches, ssd.launches) == before
        assert pm.state == frozenset() and not pm.live
        runs[str(dev)] = [(t.reach, [(s.profile, s.gpc) for s in t.slices],
                           t.tokens) for t in tenants]
    assert runs["cpu"] == runs["cuda"]
    assert [r[0] for r in runs["cuda"]] == [76, 37, 17]


def _variant_cfg(flag, dtype):
    """gemma3's smoke config with a window of 16 and 5 layers (2 groups of
    a local and a global layer, then a local tail) and ``flag`` set."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-27b"),
                              sliding_window=16, n_layers=5,
                              attn_impl="pallas", **{flag: True})
    params = cast_tree(registry.init_params(
        torch.Generator().manual_seed(0), cfg)[0], dtype)
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["windowed_cache", "kv_quant"])
def test_cache_variant_prefill_and_decode_on_card_match_cpu(card, flag):
    """f32 weights, prompts of 40 tokens in a context of 64 (every ring
    wraps): the prefill on the card (each layer's attention on the simt
    flash kernel, the 3 local layers with their window) and 6 decode
    steps, against the same calls on the CPU; logits and float cache
    leaves within 1e-4 of their largest entry (f32 sums in other orders;
    1e-3 for int8, where such a difference can move a code across a tie,
    as tests/test_torch_cache_variants.py says), int8 codes at most one
    apart."""
    cfg, params = _variant_cfg(flag, torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 40)))
    tol = 1e-3 if flag == "kv_quant" else 1e-4
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            caches = {k: v if v.dtype == torch.int8 else v.float()
                      for k, v in registry.init_caches(cfg, 3, 64,
                                                       dev).items()}
            before, windowed = _route_counts(), fa.windowed_launches
            logits, caches = registry.prefill_caches(p, cfg, tokens.to(dev),
                                                     caches)
            want = cfg.n_layers if dev == "cuda" else 0
            assert _moved(before) == {"sm90": 0, "simt": want}
            assert fa.windowed_launches - windowed == (3 if want else 0)
            steps = [logits]
            nxt = logits[:, -1, :cfg.vocab].argmax(-1)[:, None]
            for pos in range(40, 46):
                lg, caches = registry.decode_step(p, cfg, nxt, pos, caches)
                steps.append(lg)
                nxt = lg[:, -1, :cfg.vocab].argmax(-1)[:, None]
            out[dev] = {"logits": torch.cat(steps, 1), **caches}
    for name, ref in out["cpu"].items():
        got = out["cuda"][name].cpu()
        if ref.dtype == torch.int8:
            assert int((got.int() - ref.int()).abs().max()) <= 1, name
            continue
        err = (got - ref).abs().max() / ref.abs().max()
        assert float(err) < tol, (name, float(err))


@pytest.mark.cuda
def test_bf16_cache_variants_fill_as_the_plain_cache_on_sm90(card):
    """bf16 weights, prompts of 40 tokens in 64: each variant's prefill
    makes one sm90 flash launch a layer; each local layer's ring slot
    p mod 16 equals the plain cache's position p bit for bit for p in
    24..39, each global layer's cache the plain cache's layer; the first
    layer's int8 K/V (same input as the plain run's) dequantize to within
    one scale step of the plain cache's."""
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (3, 40))).to(card)
    caches = {}
    with torch.inference_mode():
        for flag in ("windowed_cache", "kv_quant", None):
            cfg, params = _variant_cfg(flag or "windowed_cache",
                                       torch.bfloat16)
            if flag is None:
                cfg = dataclasses.replace(cfg, windowed_cache=False)
            params = tree_map(lambda t: t.to(card), params)
            c = registry.init_caches(cfg, 3, 64, card)
            before = _route_counts()
            registry.prefill_caches(params, cfg, tokens, c)
            assert _moved(before) == {"sm90": cfg.n_layers, "simt": 0}
            caches[flag] = c
    plain, ring, q = caches[None], caches["windowed_cache"], \
        caches["kv_quant"]
    pos = torch.arange(24, 40, device=card)
    for name in ("k", "v"):
        for g, layer in ((0, 0), (1, 2)):
            assert torch.equal(ring[f"local_{name}"][g, 0][:, pos % 16],
                               plain[name][layer][:, pos])
        assert torch.equal(ring[f"tail_{name}"][0][:, pos % 16],
                           plain[name][4][:, pos])
        for g, layer in ((0, 1), (1, 3)):
            assert torch.equal(ring[f"global_{name}"][g], plain[name][layer])
        codes, scales = q[f"{name}_q"][0, :, :40], q[f"{name}_s"][0, :, :40]
        err = (codes.float() * scales - plain[name][0, :, :40].float()).abs()
        assert bool((err <= scales * (1 + 1e-3)).all())
