"""The port's CUDA kernels on the card, against their plain versions.

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
from repro_torch.kernels.ops import flash_mha
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import registry, transformer
from repro_torch.models.module import cast_tree

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda")


def _bhsd(x):
    return x.transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 256, 8, 4, 128, True, None), (1, 200, 4, 1, 64, True, 64),
    (1, 200, 2, 2, 64, False, None), (1, 128, 2, 2, 32, True, 32),
    (1, 128, 2, 1, 256, True, None)])
def test_kernel_matches_plain(card, dtype, b, s, h, kh, d, causal, window):
    rng = np.random.default_rng(s + h + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d),
                                                    dtype=np.float32))
               .to(card, dtype) for n in (h, kh, kh))
    before = fa.launches
    out = flash_mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = _bhsd(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                              window=window))
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


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
