"""Which flash-attention kernel a call goes to, and the strided inputs the
bf16 wgmma route takes, on the CPU.

``route(dtype, D)`` is held for every pair the wrapper takes.  The adapter
``kernels/ops.flash_mha`` hands the sm90 route transposed views instead of
contiguous copies; on the CPU those views go to the plain version, which is
held here against the reference's Pallas kernel in interpret mode on
strided inputs (a slice of a KV cache, a slice of a fused projection).  The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_mha as ref_flash_mha
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_mha

F32_TOL = 2e-5   # tests/test_kernels.py:37
BF16_TOL = 2e-2  # tests/test_kernels.py:52

# the routing table the wrapper's docstring states
WANT_ROUTE = {
    (torch.float32, 32): "simt", (torch.float32, 64): "simt",
    (torch.float32, 112): "simt", (torch.float32, 128): "simt",
    (torch.float32, 256): "simt",
    (torch.bfloat16, 32): "simt", (torch.bfloat16, 64): "sm90",
    (torch.bfloat16, 112): "sm90", (torch.bfloat16, 128): "sm90",
    (torch.bfloat16, 256): "sm90",
}


def test_routing_table_covers_what_the_wrapper_takes():
    assert set(WANT_ROUTE) == {(dt, d) for dt in fa.DTYPES
                               for d in fa.HEAD_DIMS}
    assert set(WANT_ROUTE.values()) == set(fa.ROUTES)
    assert set(fa.launches_by_route) == set(fa.ROUTES)


@pytest.mark.parametrize("dtype,d", sorted(WANT_ROUTE, key=str),
                         ids=lambda x: str(x).replace("torch.", ""))
def test_route_is_a_function_of_dtype_and_head_dim(dtype, d):
    assert fa.route(dtype, d) == WANT_ROUTE[(dtype, d)]


def _strided(rng, b, s, h, kh, d, context):
    """q as a slice of a fused [B,S,H+2KH,D] projection; k/v as the first S
    positions of [B,context,KH,D] caches: the strides the model hands on."""
    fused = rng.standard_normal((b, s, h + 2 * kh, d), dtype=np.float32)
    caches = rng.standard_normal((2, b, context, kh, d), dtype=np.float32)
    caches[:, :, :s] = fused[:, :, h:].reshape(b, s, 2, kh, d).transpose(
        2, 0, 1, 3, 4)
    return fused, caches


# (name, b, s, h, kh, d, dtype, window): causal, as the model calls it
CASES = [
    ("bf16-d128-gqa2", 2, 128, 4, 2, 128, "bf16", None),
    ("bf16-d64-ragged-s100", 1, 100, 4, 2, 64, "bf16", None),
    ("bf16-d64-window32-gqa4", 1, 192, 4, 1, 64, "bf16", 32),
    ("bf16-d32-simt", 1, 128, 2, 2, 32, "bf16", None),
    ("f32-d64-simt", 2, 128, 4, 4, 64, "f32", None),
    ("f32-d128-ragged-s70", 1, 70, 2, 1, 128, "f32", 64),
    # zamba2's head dim, MHA: bf16 on the sm90 route, f32 on simt
    ("bf16-d112-mha-ragged-s100", 2, 100, 2, 2, 112, "bf16", None),
    ("f32-d112-mha-simt", 1, 128, 2, 2, 112, "f32", None),
    # gemma-2b's head dim, MQA: bf16 on the sm90 route, f32 on simt
    ("bf16-d256-mqa-ragged-s100", 1, 100, 4, 1, 256, "bf16", None),
    ("bf16-d256-mqa-window32", 1, 192, 8, 1, 256, "bf16", 32),
    ("f32-d256-mqa-simt", 1, 128, 2, 1, 256, "f32", None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_mha_on_strided_inputs_matches_reference(case):
    name, b, s, h, kh, d, dt, window = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    fused, caches = _strided(rng, b, s, h, kh, d, context=s + 64)
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tol = F32_TOL if dt == "f32" else BF16_TOL
    fused_t = torch.from_numpy(fused).to(tdt)
    caches_t = torch.from_numpy(caches).to(tdt)
    q = fused_t[:, :, :h]
    k, v = caches_t[0, :, :s], caches_t[1, :, :s]
    assert not q.is_contiguous()
    out = flash_mha(q, k, v, causal=True, window=window)
    assert out.shape == (b, s, h, d) and out.dtype == tdt
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jdt)
                  for x in (q, k, v))
    ref = np.asarray(ref_flash_mha(jq, jk, jv, causal=True, window=window,
                                   interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)


def test_tma_strides_of_model_layout_views():
    """[B,S,N,D] views transposed to [B,N,S,D] (the sm90 route's input) and
    cache slices give their element strides as they are."""
    x = torch.zeros((2, 128, 4, 64), dtype=torch.bfloat16)
    assert fa.tma_strides(x.transpose(1, 2)) == (128 * 4 * 64, 64, 4 * 64)
    cache = torch.zeros((2, 256, 4, 64), dtype=torch.bfloat16)
    view = cache[:, :128].transpose(1, 2)
    assert fa.tma_strides(view) == (256 * 4 * 64, 64, 4 * 64)


def test_tma_strides_of_an_mqa_cache_slice():
    """gemma-2b's K/V: the first S positions of a [B,C,1,256] cache layer,
    transposed; its one KV head is never walked."""
    cache = torch.zeros((3, 2, 1024, 1, 256), dtype=torch.bfloat16)
    view = cache[1][:, :200].transpose(1, 2)
    assert view.shape == (2, 1, 200, 256)
    strides = fa.tma_strides(view)
    assert strides == (1024 * 256, 200 * 256, 256)
    assert all(st % 8 == 0 for st in strides)


def test_tma_strides_of_a_size_one_dimension_are_never_walked():
    x = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16)
    strides = fa.tma_strides(x.transpose(1, 2))
    assert strides == (64 * 64, 64 * 64, 64)
    assert all(st % 8 == 0 for st in strides)


@pytest.mark.parametrize("bad", ["d_not_contiguous", "odd_stride",
                                 "misaligned_base"])
def test_tma_strides_reject_what_the_tensor_maps_cannot_take(bad):
    if bad == "d_not_contiguous":
        x = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16).transpose(2, 3)
    elif bad == "odd_stride":
        # rows of 68 bf16 values: 136 bytes, not a multiple of 16
        x = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16)[..., :64]
    else:
        x = torch.zeros(1 + 2 * 64 * 64, dtype=torch.bfloat16)[1:].view(
            1, 2, 64, 64)
    with pytest.raises(ValueError):
        fa.tma_strides(x)
