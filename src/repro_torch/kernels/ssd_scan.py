"""Wrapper of the hand-written Hopper SSD chunk-scan kernel.

``ssd_scan`` takes the model layout (x [B,S,H,P], dt [B,S,H], a [H],
b/c [B,S,N]) and computes the Mamba2 SSD recurrence chunk by chunk, with
the state carried in f32; it returns y in x's dtype and the final state
[B,H,P,N] in f32.  A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.ssd_ref`).  A CUDA tensor goes to one of
two kernels, by :func:`route`, a function of x's dtype, P, N and the chunk
alone decided before the launch:

- ``"sm90"``: bf16 x at P=64, N in ``SM90_STATES`` (64, 128) and a chunk
  that is a multiple of 64 goes to ``csrc/ssd_scan_sm90.cu`` (``wgmma``
  for every product, C Bᵀ once per batch row for each pair of heads, the
  state update at f32 grade from hi/lo bf16 splits).  The kernel is built
  for N=128; at N=64 the wrapper zero-pads B and C to 128 columns and
  returns the first 64 state columns.  That is exact: zero B columns inject
  nothing into state columns 64-127, which so stay zero from the zero
  start, and zero C columns read nothing from them;
- ``"simt"``: every other call (f32 x, which f32 parity at 2e-4 holds to
  f32 products, and bf16 at other P, N or chunks) goes to
  ``csrc/ssd_scan.cu`` (CUDA-core f32 products).

A failed build or launch on either route raises; no call is retried on
the other kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.ref import ssd_ref

HEAD_DIMS = (16, 32, 64, 128)   # P
MAX_STATE = 128                 # N
MAX_CHUNK = 1024                # Q
DTYPES = (torch.float32, torch.bfloat16)
#: P and N the bf16 wgmma kernel is built for, and the rows of its step:
#: the chunk must be a multiple of it
SM90_HEAD_DIM, SM90_STATE, SM90_STEP = 64, 128, 64
#: the N the sm90 route takes (N below SM90_STATE zero-padded to it)
SM90_STATES = (64, SM90_STATE)
ROUTES = ("sm90", "simt")

#: kernel launches in this process, in all and by route; only CUDA calls
#: count
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


def route(dtype: torch.dtype, head_dim: int, state_dim: int,
          chunk: int) -> str:
    """The kernel a CUDA call of this x dtype, P, N and chunk goes to."""
    if (dtype == torch.bfloat16 and head_dim == SM90_HEAD_DIM
            and state_dim in SM90_STATES and chunk % SM90_STEP == 0):
        return "sm90"
    return "simt"


#: the library of each route; its C entry ``<library>_fwd`` takes the same
#: arguments on both routes
LIBRARIES = {"sm90": "ssd_scan_sm90", "simt": "ssd_scan"}


@functools.cache
def _entry(route_name: str):
    name = LIBRARIES[route_name]
    lib = build.load(name)
    fn = getattr(lib, f"{name}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           b_in: torch.Tensor, c_in: torch.Tensor, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"want x [B,S,H,P]; got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_in.shape[-1] if b_in.dim() == 3 else -1
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b_in.shape) != (bsz, s, n)
            or tuple(c_in.shape) != (bsz, s, n)):
        raise ValueError(f"want dt [B,S,H], a [H], b/c [B,S,N] for x "
                         f"{tuple(x.shape)}; got {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b_in.shape)}, "
                         f"{tuple(c_in.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {DTYPES}, got {x.dtype}")
    for name, t in (("dt", dt), ("a", a), ("b", b_in), ("c", c_in)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if len({t.device for t in (x, dt, a, b_in, c_in)}) != 1:
        raise ValueError("x, dt, a, b and c must be on one device")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim P={p} not in {HEAD_DIMS}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state dim N={n} outside [1, {MAX_STATE}]")
    if not 1 <= chunk <= MAX_CHUNK or s == 0 or s % chunk:
        raise ValueError(f"S={s} must be a positive multiple of the chunk "
                         f"{chunk}, and the chunk in [1, {MAX_CHUNK}]")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,H,P]; dt: [B,S,H] (post-softplus); a: [H] (< 0);
    b_in/c_in: [B,S,N] -> (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] f32).  S must be a multiple of ``chunk``.  Raises
    RuntimeError, on every device, when grad is enabled and an input
    requires grad: there is no backward."""
    _check(x, dt, a, b_in, c_in, chunk)
    refuse_grad("ssd_scan", x, dt, a, b_in, c_in)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a, b_in, c_in)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, a, b_in, c_in)):
        raise ValueError("x, dt, a, b and c must be contiguous")
    return _launch(route(x.dtype, x.shape[3], b_in.shape[2], chunk), x, dt,
                   a, b_in, c_in, chunk)


def _launch(route_name: str, x: torch.Tensor, dt: torch.Tensor,
            a: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the named route's kernel on checked contiguous CUDA
    tensors."""
    global launches
    fn, err = _entry(route_name)
    bsz, s, h, p = x.shape
    n_out = b_in.shape[-1]
    if route_name == "sm90" and n_out < SM90_STATE:
        b_in, c_in = (F.pad(t, (0, SM90_STATE - n_out)) for t in (b_in, c_in))
    if route_name == "simt":
        # the simt kernel stages x, B and C by 16-byte cp.async: B and C get
        # zero columns up to a multiple of 4, and a view at another offset
        # is copied to a fresh buffer
        if n_out % 4:
            b_in, c_in = (F.pad(t, (0, -n_out % 4)) for t in (b_in, c_in))
        x, b_in, c_in = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (x, b_in, c_in))
    n = b_in.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), y.data_ptr(), state.data_ptr())
    with torch.cuda.device(x.device):
        rc = fn(*ptrs, bsz, s, h, p, n, chunk, int(x.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan ({route_name}) launch failed: "
                           f"{err(rc).decode()} (code {rc})")
    launches += 1
    launches_by_route[route_name] += 1
    if n > n_out:
        state = state[..., :n_out].contiguous()
    return y, state
