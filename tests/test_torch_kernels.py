"""The port's flash attention (kernels/ops.flash_mha) against the reference's
Pallas kernel run in interpret mode and against its oracle, on the CPU,
where the port's wrapper takes its plain version.  The kernel itself runs
only on the card (tests/test_torch_cuda.py)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_mha as ref_flash_mha
from repro.kernels.ref import attention_ref as ref_attention_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_mha
from repro_torch.kernels.ref import attention_ref

F32_TOL = 2e-5   # tests/test_kernels.py:37
BF16_TOL = 2e-2  # tests/test_kernels.py:52


def _mk(seed, b, s, h, kh, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d), dtype=np.float32)
            for n in (h, kh, kh)]


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


# (name, b, s, h, kh, d, dtype, causal, window, tol): the sweep of
# tests/test_kernels.py:29-80
SWEEP = (
    [(f"causal-s{s}-h{h}kh{kh}", 2, s, h, kh, 64, "f32", True, None, F32_TOL)
     for s in (128, 256, 384) for h, kh in ((4, 4), (4, 2), (8, 1))]
    + [(f"window{w}", 2, 256, 4, 2, 64, "f32", True, w, F32_TOL)
       for w in (32, 128, 1024)]
    + [("dtype-f32", 1, 128, 2, 2, 128, "f32", True, None, F32_TOL),
       ("dtype-bf16", 1, 128, 2, 2, 128, "bf16", True, None, BF16_TOL),
       ("non-causal", 1, 128, 2, 2, 64, "f32", False, None, F32_TOL),
       ("ragged-s200", 1, 200, 2, 2, 64, "f32", True, None, F32_TOL)]
    + [(f"random-s{s}-h{h}-d{d}", 1, s, h, h, d, "f32", True, None, 3e-5)
       for s, h, d in ((128, 2, 32), (256, 4, 64), (128, 4, 64),
                       (256, 2, 32))]
)


@pytest.mark.parametrize("case", SWEEP, ids=[c[0] for c in SWEEP])
def test_flash_mha_matches_reference(case):
    name, b, s, h, kh, d, dt, causal, window, tol = case
    q, k, v = _mk(zlib.crc32(name.encode()), b, s, h, kh, d)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    ref_kernel = np.asarray(ref_flash_mha(jq, jk, jv, causal=causal,
                                          window=window, interpret=True
                                          ).astype(jnp.float32))
    ref_oracle = np.asarray(_bhsd(ref_attention_ref(
        _bhsd(jq), _bhsd(jk), _bhsd(jv), causal=causal, window=window)
    ).astype(jnp.float32))
    out = flash_mha(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                    causal=causal, window=window)
    assert out.dtype == tdt and out.shape == (b, s, h, d)
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref_kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(out, ref_oracle, atol=tol, rtol=tol)


def test_non_causal_ragged_hides_padding():
    """The port masks padded keys; the reference kernel attends to the
    zero pad when causal=False and S is ragged, so only the oracle on the
    unpadded inputs is the target here."""
    q, k, v = _mk(5, 1, 200, 2, 2, 64)
    ref = np.asarray(_bhsd(ref_attention_ref(
        *(_bhsd(jnp.asarray(x)) for x in (q, k, v)), causal=False)))
    out = flash_mha(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


def test_attention_ref_matches_reference_oracle():
    q, k, v = (_bhsd(x) for x in _mk(6, 2, 64, 4, 2, 32))
    ref = np.asarray(ref_attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                       causal=True, window=16))
    out = attention_ref(*(torch.from_numpy(np.ascontiguousarray(x))
                          for x in (q, k, v)), causal=True, window=16)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


def test_cpu_call_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(np.ascontiguousarray(_bhsd(x)))
               for x in _mk(7, 1, 64, 2, 2, 32))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True, kv_len=50)
    assert fa.launches == before
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=True,
                                                  kv_len=50))


@pytest.mark.parametrize("bad", ["seq", "dtype", "head_dim", "kv_len",
                                 "window", "groups"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    shapes = {"q": (1, 4, 64, 32), "k": (1, 2, 64, 32)}
    dtype = torch.float32
    kw = {}
    if bad == "seq":
        shapes = {"q": (1, 4, 60, 32), "k": (1, 2, 60, 32)}
    elif bad == "dtype":
        dtype = torch.float16
    elif bad == "head_dim":
        shapes = {"q": (1, 4, 64, 48), "k": (1, 2, 64, 48)}
    elif bad == "kv_len":
        kw = {"kv_len": 65}
    elif bad == "window":
        kw = {"window": 0}
    elif bad == "groups":
        shapes = {"q": (1, 3, 64, 32), "k": (1, 2, 64, 32)}
    q = torch.zeros(shapes["q"], dtype=dtype)
    k = torch.zeros(shapes["k"], dtype=dtype)
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, k.clone(), **kw)
