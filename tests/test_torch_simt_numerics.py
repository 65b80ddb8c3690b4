"""The order of arithmetic of the CUDA-core ("simt") kernels, on the CPU.

The kernels (kernels/csrc/flash_attention.cu and ssd_scan.cu) run only on
the card (tests/test_torch_cuda.py), so their blocking is checked here by
plain PyTorch emulations written in this file, held against the
reference's Pallas kernels in interpret mode and against its oracles at
the reference's f32 limits (2e-5 for attention, 2e-4 for SSD y and the
state; tests/test_kernels.py).

- Flash: a block owns 64 packed rows of one KV head's GQA group in
  position-major order (row R: position R // G, head R % G of the group)
  and walks only the 64-key tiles its rows can see; the scale is folded
  into the scores in log2 units and the softmax is taken with exp2; a row
  that sees no key keeps m = -inf, l = 0 and writes 0.
- SSD: the sequence is walked in steps of 32 rows whatever the chunk, with
  C B^T formed once a step for all the heads of a block, each head's decay
  and dt applied after it (masked before the exponential), the C . state
  term from the state at the step's start (none at the first step), and
  the state decayed and then updated in f32.
"""

import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ops import flash_mha as ref_flash_mha
from repro.kernels.ops import ssd_mixer as ref_ssd_mixer
from repro.kernels.ref import attention_ref as ref_attention_ref
from repro.kernels.ref import ssd_ref as ref_ssd_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import attention_ref

F32_TOL = 2e-5        # tests/test_kernels.py:37
BF16_TOL = 2e-2       # tests/test_kernels.py:52
SSD_F32_TOL = 2e-4    # tests/test_kernels.py:99
SSD_BF16_TOL = 5e-2   # tests/test_kernels.py:123
LOG2E = np.float32(1.4426950408889634)
ROWS = 64             # packed query rows of a flash block
KEYS = 64             # keys of a KV tile
STEP = 32             # rows of an SSD step


def emulate_flash(q, k, v, *, causal, window, kv_len):
    """The simt flash kernel's arithmetic: q [B,H,Sq,D], k/v [B,KH,Sk,D]
    (Sq, Sk multiples of 64) -> [B,H,Sq,D] in q's dtype."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    g = h // kh
    scale_log2 = float(LOG2E / np.sqrt(np.float32(d)))
    packed = (q.float().reshape(b, kh, g, sq, d).permute(0, 1, 3, 2, 4)
              .reshape(b, kh, sq * g, d))
    out = torch.empty_like(packed)
    for r0 in range(0, sq * g, ROWS):
        pos = torch.arange(r0, r0 + ROWS) // g
        pos_lo, pos_hi = r0 // g, (r0 + ROWS - 1) // g
        kv_hi = min(kv_len, sk)
        if causal:
            kv_hi = min(kv_hi, pos_hi + 1)
        kv_lo = max(0, pos_lo - window + 1) if window else 0
        tiles = range(kv_lo // KEYS, -(-kv_hi // KEYS)) if kv_hi > kv_lo \
            else range(0)
        m = torch.full((b, kh, ROWS), -math.inf)
        l = torch.zeros((b, kh, ROWS))
        acc = torch.zeros((b, kh, ROWS, d))
        rows = packed[:, :, r0:r0 + ROWS]
        for t in tiles:
            k0 = t * KEYS
            kt = k[:, :, k0:k0 + KEYS].float()
            vt = v[:, :, k0:k0 + KEYS].float()
            s = (rows @ kt.transpose(-1, -2)) * scale_log2
            kpos = torch.arange(k0, k0 + KEYS)
            ok = (kpos < kv_len)[None, :].expand(ROWS, KEYS)
            if causal:
                ok = ok & (kpos[None, :] <= pos[:, None])
            if window:
                ok = ok & (pos[:, None] - kpos[None, :] < window)
            s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(s - m_use[..., None])
            l = l * alpha + p.sum(-1)
            m = m_new
            acc = acc * alpha[..., None] + p @ vt
        out[:, :, r0:r0 + ROWS] = acc / l.clamp(min=1e-30)[..., None]
    return (out.reshape(b, kh, sq, g, d).permute(0, 1, 3, 2, 4)
            .reshape(b, h, sq, d).to(q.dtype))


def emulate_flash_mha(q, k, v, *, causal, window):
    """kernels/ops.flash_mha around the emulated kernel: model layout
    [B,S,H,D], S zero-padded to a multiple of 64 and hidden by kv_len."""
    s = q.shape[1]
    pad = (-s) % ROWS

    def to_kernel(x):
        return F.pad(x, (0, 0, 0, 0, 0, pad)).transpose(1, 2)

    out = emulate_flash(to_kernel(q), to_kernel(k), to_kernel(v),
                        causal=causal, window=window, kv_len=s)
    return out.transpose(1, 2)[:, :s]


def emulate_ssd(x, dt, a, b_in, c_in):
    """The simt SSD kernel's arithmetic: x [B,S,H,P] (any S), dt [B,S,H],
    a [H], b/c [B,S,N] -> (y in x's dtype, final state [B,H,P,N] f32)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    a2 = a.float() * float(LOG2E)
    state = torch.zeros((bsz, h, p, n))
    y = torch.empty((bsz, s, h, p))
    causal = torch.tril(torch.ones((STEP, STEP), dtype=torch.bool))
    for s0 in range(0, s, STEP):
        rows = min(STEP, s - s0)

        def step(t):     # this step's rows, zero-filled past the end
            t = t[:, s0:s0 + rows].float()
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, STEP - rows))

        xq, dtq, bq, cq = step(x), step(dt), step(b_in), step(c_in)
        cs = torch.cumsum(dtq * a2, dim=1)                    # [B,T,H]
        cb = torch.einsum("bjn,bin->bji", cq, bq)             # once a step
        mask = causal[None, :, :, None]
        arg = torch.where(mask, cs[:, :, None, :] - cs[:, None, :, :],
                          -math.inf)
        scores = torch.where(mask, cb[..., None] * torch.exp2(arg)
                             * dtq[:, None, :, :], 0.0)       # [B,j,i,H]
        yq = torch.zeros((bsz, STEP, h, p))
        if s0:
            yq = (torch.einsum("bjn,bhpn->bjhp", cq, state)
                  * torch.exp2(cs)[..., None])
        yq = yq + torch.einsum("bjih,bihp->bjhp", scores, xq)
        y[:, s0:s0 + rows] = yq[:, :rows]
        tot = cs[:, -1]                                       # [B,H]
        w = torch.exp2(tot[:, None] - cs) * dtq               # [B,T,H]
        state = (torch.exp2(tot)[..., None, None] * state
                 + torch.einsum("bihp,bin->bhpn", w[..., None] * xq, bq))
    return y.to(x.dtype), state


def emulate_ssd_mixer(x, dt, a, b_in, c_in, chunk):
    """kernels/ops.ssd_mixer around the emulated kernel: S zero-padded to a
    chunk multiple (dt = 0), y cut back; the kernel ignores the chunk."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    y, state = emulate_ssd(x, dt, a, b_in, c_in)
    return y[:, :s], state


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


# (name, B, S, H, KH, D, causal, window): every head dim the simt route
# takes, GQA groups 1, 2, 5, 6 and 8 (packed 64 rows a block), causal and
# not, windows, and a ragged S of 200 (padded to 256, hidden by kv_len)
FLASH_CASES = [
    ("d32-g1", 1, 128, 2, 2, 32, True, None),
    ("d64-g2", 2, 256, 4, 2, 64, True, None),
    ("d112-g1", 1, 128, 2, 2, 112, True, None),
    ("d128-g5", 1, 128, 5, 1, 128, True, None),
    ("d256-g8", 1, 128, 8, 1, 256, True, None),
    ("d128-g6-window96", 1, 256, 6, 1, 128, True, 96),
    ("d256-g1-window64", 1, 256, 2, 2, 256, True, 64),
    ("d64-g2-non-causal", 1, 128, 4, 2, 64, False, None),
    ("d112-g2-non-causal", 1, 128, 4, 2, 112, False, None),
    ("d32-g8-window32", 1, 256, 8, 1, 32, True, 32),
    ("ragged-s200-d128-g2", 1, 200, 4, 2, 128, True, None),
    ("ragged-s200-d64-g8-window100", 1, 200, 8, 1, 64, True, 100),
    ("ragged-s200-d112-g5", 1, 200, 5, 1, 112, True, None),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_blocking_matches_reference_kernel_and_oracle(case):
    name, b, s, h, kh, d, causal, window = case
    assert fa.route(torch.float32, d) == "simt"
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v = (rng.standard_normal((b, s, n, d), dtype=np.float32)
               for n in (h, kh, kh))
    out = emulate_flash_mha(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal, window=window).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    oracle = np.asarray(_bhsd(ref_attention_ref(
        _bhsd(jq), _bhsd(jk), _bhsd(jv), causal=causal, window=window)))
    np.testing.assert_allclose(out, oracle, atol=F32_TOL, rtol=F32_TOL)
    kernel = np.asarray(ref_flash_mha(jq, jk, jv, causal=causal,
                                      window=window, interpret=True))
    np.testing.assert_allclose(out, kernel, atol=F32_TOL, rtol=F32_TOL)


def test_flash_blocking_of_bf16_at_d32_matches_reference():
    """bf16 at D=32 is the one bf16 call the simt route takes: inputs stay
    bf16 and are widened at use, every product and the softmax in f32."""
    rng = np.random.default_rng(32)
    q, k, v = (rng.standard_normal((1, 200, n, 32), dtype=np.float32)
               for n in (6, 2, 2))
    assert fa.route(torch.bfloat16, 32) == "simt"
    out = emulate_flash_mha(*(torch.from_numpy(x).to(torch.bfloat16)
                              for x in (q, k, v)), causal=True, window=None)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    kernel = np.asarray(ref_flash_mha(jq, jk, jv, interpret=True)
                        .astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), kernel, atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_non_causal_ragged_blocking_hides_the_pad():
    """Non-causal and ragged: the kernel hides the zero pad by kv_len, where
    the reference kernel attends to it, so the oracle on the unpadded
    inputs is the target."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 200, n, 32), dtype=np.float32)
               for n in (5, 1, 1))
    out = emulate_flash_mha(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=False, window=None).numpy()
    oracle = np.asarray(_bhsd(ref_attention_ref(
        *(_bhsd(jnp.asarray(x)) for x in (q, k, v)), causal=False)))
    np.testing.assert_allclose(out, oracle, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kv_len", [0, 64])
def test_rows_that_see_no_key_write_zero(kv_len):
    """Non-causal with every key hidden (kv_len 0), and causal rows whose
    window holds only hidden keys: m stays -inf, l = 0, the output is 0,
    as the plain version gives."""
    rng = np.random.default_rng(kv_len)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 256, 64),
                                                    dtype=np.float32))
               for n in (4, 2, 2))
    causal, window = (False, None) if kv_len == 0 else (True, 32)
    out = emulate_flash(q, k, v, causal=causal, window=window, kv_len=kv_len)
    ref = attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    hidden = torch.arange(256) >= kv_len + (window or 0) - 1
    if kv_len == 0:
        hidden[:] = True
    assert torch.isfinite(out).all()
    assert not out[:, :, hidden].any()
    torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)


def _ssd_inputs(seed, b, s, h, p, n):
    """The reference tests' SSD inputs (tests/test_kernels.py:81-90)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.2)
    bc = [rng.standard_normal((b, s, n), dtype=np.float32) * 0.3
          for _ in range(2)]
    return [x, dt, a, *bc]


# (name, B, S, H, P, N, chunk, x dtype): every P the wrapper takes (P=128
# in two halves of the state a block), N at 16, 64, 100 and 128, chunks of
# 32 to 1024 and partial chunks (S padded to the chunk), odd H (a block's
# second head idle), bf16 x off the sm90 route
SSD_CASES = [
    ("p16-n16-q32-h3", 1, 96, 3, 16, 16, 32, "f32"),
    ("p32-n100-q64", 2, 128, 2, 32, 100, 64, "f32"),
    ("p64-n128-q256-partial-s200", 1, 200, 3, 64, 128, 256, "f32"),
    ("p128-n64-q128", 1, 256, 2, 128, 64, 128, "f32"),
    ("p64-n64-q1024", 1, 1024, 1, 64, 64, 1024, "f32"),
    ("p128-n128-q32-h3", 1, 64, 3, 128, 128, 32, "f32"),
    ("p16-n128-q100-partial-s150", 1, 150, 2, 16, 128, 100, "f32"),
    ("p32-n16-q512-partial-s40", 1, 40, 4, 32, 16, 512, "f32"),
    ("bf16-p128-n16-q32", 1, 96, 2, 128, 16, 32, "bf16"),
]


@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_ssd_blocking_matches_reference_oracle_and_kernel(case):
    name, b, s, h, p, n, chunk, dt_name = case
    dtype = torch.float32 if dt_name == "f32" else torch.bfloat16
    assert ssd.route(dtype, p, n, chunk) == "simt"
    args = _ssd_inputs(zlib.crc32(name.encode()), b, s, h, p, n)
    x = torch.from_numpy(args[0]).to(dtype)
    targs = [x, *(torch.from_numpy(t) for t in args[1:])]
    y, state = emulate_ssd_mixer(*targs, chunk=chunk)
    assert y.dtype == dtype and y.shape == (b, s, h, p)
    assert state.shape == (b, h, p, n)
    jargs = [jnp.asarray(x.float().numpy()), *(jnp.asarray(t)
                                               for t in args[1:])]
    y_ref, state_ref = ref_ssd_ref(*jargs)
    tol = SSD_F32_TOL if dt_name == "f32" else SSD_BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_ref),
                               atol=SSD_F32_TOL, rtol=SSD_F32_TOL)
    jx = jargs[0] if dt_name == "f32" else jargs[0].astype(jnp.bfloat16)
    y_kernel = ref_ssd_mixer(jx, *jargs[1:], chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_kernel.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_ssd_step_walk_ignores_the_chunk():
    """The kernel's 32-row steps do not depend on the chunk: on the same
    (already chunk-padded) inputs, chunks 32, 64 and 256 give one y and
    one state bit for bit, and the step walk agrees with the oracle."""
    args = [torch.from_numpy(t) for t in _ssd_inputs(11, 1, 256, 2, 64, 64)]
    outs = [emulate_ssd_mixer(*args, chunk=q) for q in (32, 64, 256)]
    for y, state in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(state, outs[0][1])
    y_ref, state_ref = ref_ssd_ref(*(jnp.asarray(t.numpy()) for t in args))
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(y_ref),
                               atol=SSD_F32_TOL, rtol=SSD_F32_TOL)
    np.testing.assert_allclose(outs[0][1].numpy(), np.asarray(state_ref),
                               atol=SSD_F32_TOL, rtol=SSD_F32_TOL)
