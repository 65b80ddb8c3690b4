"""Which SSD chunk-scan kernel a call goes to, and the numerics of the bf16
wgmma route, on the CPU.

``route(dtype, P, N, Q)`` is held for every class of call the wrapper
takes, and a CPU call is shown to take the plain version without counting
a launch.  The kernels themselves run only on the card
(tests/test_torch_cuda.py), so the precision plan of the sm90 kernel is
checked here by a plain PyTorch emulation written in this file: it walks
the sequence in 64-row steps and rounds to bf16 exactly where the kernel
rounds (C, B, the scores with dt folded in, and the state on the y path)
and takes the state update from the three products of hi/lo bf16 splits.
The emulation is held against the reference's sequential oracle and its
Pallas kernel in interpret mode, at the tolerances the card holds the
kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_mixer as ref_ssd_mixer
from repro.kernels.ref import ssd_ref as ref_ssd_ref
from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_ref

Y_TOL = 5e-2        # bf16 y, tests/test_kernels.py:123
STATE_TOL = 2e-4    # the final state, f32 in both dtypes (test_kernels.py:99)
STEP = 64           # rows of the sm90 kernel's step

# The classes of call the wrapper takes: every P it takes, N at the sm90
# route's 64 (zamba2, zero-padded to 128) and 128 (mamba2) and off them,
# chunks that are multiples of 64 and one that is not.  The sm90 route
# takes bf16 x at P=64, N 64 or 128 and a chunk that is a multiple of 64;
# everything else goes to the CUDA-core kernel.
SM90 = {(torch.bfloat16, 64, n, q) for n in (64, 128)
        for q in (64, 128, 256, 1024)}
CLASSES = [(dt, p, n, q) for dt in ssd.DTYPES for p in ssd.HEAD_DIMS
           for n in (16, 64, 100, 128) for q in (32, 64, 128, 256, 1024)]


def test_routing_table_covers_what_the_wrapper_takes():
    assert SM90 <= set(CLASSES)
    assert set(ssd.ROUTES) == {"sm90", "simt"}
    assert set(ssd.launches_by_route) == set(ssd.ROUTES)
    # one library a route, each built from the package's sources
    assert set(ssd.LIBRARIES) == set(ssd.ROUTES)
    assert set(ssd.LIBRARIES.values()) <= set(build.SOURCES)


@pytest.mark.parametrize("dtype,p,n,q", CLASSES,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_route_is_a_function_of_dtype_p_n_and_chunk(dtype, p, n, q):
    want = "sm90" if (dtype, p, n, q) in SM90 else "simt"
    assert ssd.route(dtype, p, n, q) == want


def _inputs(seed, b, s, h, p, n, bc_bf16=False):
    """The reference tests' SSD inputs (tests/test_kernels.py:81-90), drawn
    with numpy; with ``bc_bf16`` B and C hold bf16 values, as on the
    model's path (the conv output is bf16)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.2)
    bc = [rng.standard_normal((b, s, n), dtype=np.float32) * 0.3
          for _ in range(2)]
    x = torch.from_numpy(x).to(torch.bfloat16)
    bc = [torch.from_numpy(t) for t in bc]
    if bc_bf16:
        bc = [t.to(torch.bfloat16).float() for t in bc]
    return (x, torch.from_numpy(dt), torch.from_numpy(a), *bc)


def test_cpu_call_takes_the_plain_version_and_counts_no_launch():
    x, dt, a, b_in, c_in = _inputs(0, 1, 128, 2, 64, 128)
    assert ssd.route(x.dtype, 64, 128, 64) == "sm90"
    before, by_route = ssd.launches, dict(ssd.launches_by_route)
    y, state = ssd.ssd_scan(x, dt, a, b_in, c_in, chunk=64)
    assert ssd.launches == before
    assert ssd.launches_by_route == by_route
    y_ref, state_ref = ssd_ref(x, dt, a, b_in, c_in)
    assert torch.equal(y, y_ref) and torch.equal(state, state_ref)


def _bf(t):
    return t.to(torch.bfloat16).float()


def emulate_sm90(x, dt, a, b_in, c_in, split_state=True):
    """The sm90 kernel's arithmetic in plain PyTorch (f32 sums, bf16 where
    the kernel rounds); S a multiple of 64.  ``split_state=False`` takes the
    state update from one bf16 product instead of three."""
    bsz, s, h, p = x.shape
    state = torch.zeros((bsz, h, p, b_in.shape[-1]))
    causal = torch.tril(torch.ones((STEP, STEP), dtype=torch.bool))
    ys = []
    for s0 in range(0, s, STEP):
        rows = slice(s0, s0 + STEP)
        dtq, xq = dt[:, rows], x[:, rows].float()
        csum = torch.cumsum(dtq * a, dim=1)                     # [B,T,H]
        cq, b_hi = _bf(c_in[:, rows]), _bf(b_in[:, rows])
        b_lo = _bf(b_in[:, rows] - b_hi)
        cb = torch.einsum("bjn,bin->bji", cq, b_hi)
        seg = csum[:, :, None, :] - csum[:, None, :, :]         # [B,j,i,H]
        mask = causal[None, :, :, None]
        # dt_i folds into the scores; x is bf16 already
        scores = _bf(torch.where(
            mask, cb[..., None] * dtq[:, None, :, :]
            * torch.exp(torch.where(mask, seg, 0.0)), 0.0))
        y = torch.einsum("bjih,bihp->bjhp", scores, xq)
        if s0:
            y = y + (torch.einsum("bjn,bhpn->bjhp", cq, _bf(state))
                     * torch.exp(csum)[..., None])
        ys.append(y.to(torch.bfloat16))
        total = csum[:, -1]                                     # [B,H]
        wx = (torch.exp(total[:, None] - csum) * dtq)[..., None] * xq
        w_hi = _bf(wx)
        if split_state:
            w_lo = _bf(wx - w_hi)
            upd = (torch.einsum("bihp,bin->bhpn", w_hi, b_hi)
                   + torch.einsum("bihp,bin->bhpn", w_hi, b_lo)
                   + torch.einsum("bihp,bin->bhpn", w_lo, b_hi))
        else:
            upd = torch.einsum("bihp,bin->bhpn", w_hi, b_hi)
        state = torch.exp(total)[..., None, None] * state + upd
    return torch.cat(ys, dim=1), state


def pad_state(b_in, c_in):
    """The sm90 wrapper's padding of B and C to the kernel's N=128."""
    n = b_in.shape[-1]
    return (torch.nn.functional.pad(t, (0, ssd.SM90_STATE - n))
            for t in (b_in, c_in))


def emulate_mixer(x, dt, a, b_in, c_in, chunk):
    """ssd_mixer's padding (dt = 0 and zero x, b, c up to a chunk
    multiple) and the sm90 wrapper's (B and C to N=128, the state cut back)
    around the emulated kernel."""
    s, n = x.shape[1], b_in.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b_in = torch.nn.functional.pad(b_in, (0, 0, 0, pad))
        c_in = torch.nn.functional.pad(c_in, (0, 0, 0, pad))
    y, state = emulate_sm90(x, dt, a, *pad_state(b_in, c_in))
    return y[:, :s], state[..., :n]


def _jax(t):
    return jnp.asarray(t.float().numpy())


# (name, B, S, H, chunk, B and C bf16-exact, N): P=64 throughout
CASES = [
    ("random-bc-s192-q64", 2, 192, 2, 64, False, 128),
    ("model-bc-s256-q128", 1, 256, 2, 128, True, 128),
    ("ragged-s100-q128-h1", 1, 100, 1, 128, False, 128),
    ("zamba2-n64-s256-q256-h3", 1, 256, 3, 256, True, 64),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sm90_numerics_match_reference_oracle_and_kernel(case):
    name, b, s, h, chunk, bc_bf16, n = case
    args = _inputs(len(name) + s, b, s, h, 64, n, bc_bf16)
    assert ssd.route(args[0].dtype, 64, n, chunk) == "sm90"
    y, state = emulate_mixer(*args, chunk=chunk)
    assert y.dtype == torch.bfloat16 and y.shape == args[0].shape
    jargs = [_jax(t) for t in args]
    y_ref, state_ref = ref_ssd_ref(*jargs)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref),
                               atol=Y_TOL, rtol=Y_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_ref),
                               atol=STATE_TOL, rtol=STATE_TOL)
    y_kernel = ref_ssd_mixer(jargs[0].astype(jnp.bfloat16), *jargs[1:],
                             chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_kernel.astype(jnp.float32)),
                               atol=Y_TOL, rtol=Y_TOL)


def test_zero_padding_b_and_c_to_the_kernel_state_is_exact():
    """Why the sm90 route may run N=64 on the N=128 kernel: on B and C
    zero-padded to 128 columns the plain version gives the unpadded call's
    y and first 64 state columns, to f32 rounding, and exactly zero in
    state columns 64-127 (zero B injects nothing there, zero C reads
    nothing from there)."""
    x, dt, a, b_in, c_in = _inputs(5, 2, 96, 3, 64, 64)
    x = x.float()
    y, state = ssd_ref(x, dt, a, b_in, c_in)
    y_pad, state_pad = ssd_ref(x, dt, a, *pad_state(b_in, c_in))
    assert state_pad.shape == (2, 3, 64, ssd.SM90_STATE)
    assert not state_pad[..., 64:].any()
    torch.testing.assert_close(state_pad[..., :64], state, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(y_pad, y, rtol=1e-6, atol=1e-6)


def test_one_bf16_product_would_miss_the_state_limit():
    """Why the state update takes three products: with one bf16 product
    the final state leaves the 2e-4 limit that the split keeps."""
    args = _inputs(7, 1, 256, 2, 64, 128)
    state_ref = ssd_ref(args[0].float(), *args[1:])[1]
    errs = {}
    for split in (True, False):
        state = emulate_sm90(*args, split_state=split)[1]
        excess = (state - state_ref).abs() - STATE_TOL * state_ref.abs()
        errs[split] = float(excess.max())
    assert errs[True] < STATE_TOL < errs[False], errs
