"""Wrapper of the hand-written Hopper kernel for Mamba2's one-token
selective state update, the recurrence of the decode step.

``ssm_state_update`` takes one layer's f32 state [B,H,P,N] and the step's
x [B,H,P], dt [B,H] (before the bias and the softplus), the layer's
dt_bias, A_log and D [H] and B, C [B,N], and computes, in f32 whatever
the inputs' dtype,

    dt1    = softplus(dt + dt_bias),   a = -exp(A_log)
    state' = state * exp(dt1 a) + (dt1 x) ⊗ B
    y      = state' · C + D x

returning (y [B,H,P] f32, state').  A CUDA tensor goes to
``csrc/ssm_state_update.cu``, which reads and writes the state once and
updates it **in place**: the state returned is the tensor given.  Every
other device (the CPU, and ``meta`` where the dry run traces the step)
goes to the plain version :func:`ssm_state_update_ref`, which returns a
new state and leaves the one given as it was.  A failed build or launch
raises; no CUDA call falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, refuse_grad

#: the N the kernel is built for: the smoke configs', zamba2's, mamba2's
STATE_DIMS = (16, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: the one kernel's route, named as the other kernel modules name theirs
ROUTES = ("cuda",)

#: kernel launches in this process, in all and by route; only CUDA calls
#: count
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


def ssm_state_update_ref(state: torch.Tensor, x: torch.Tensor,
                         dt: torch.Tensor, dt_bias: torch.Tensor,
                         a_log: torch.Tensor, d: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the same function in PyTorch ops, the state
    returned as a new tensor."""
    xh = x.float()
    dt1 = F.softplus(dt.float() + dt_bias.float())             # [B,H]
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt1 * a)                                  # [B,H]
    outer = torch.einsum("bhp,bn->bhpn", dt1[..., None] * xh, b.float())
    state = state * decay[..., None, None] + outer
    y = torch.einsum("bhpn,bn->bhp", state, c.float())
    y = y + d.float()[None, :, None] * xh
    return y, state


@functools.cache
def _entry():
    lib = build.load("ssm_state_update")
    fn = lib.ssm_state_update_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = lib.ssm_state_update_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _check(state, x, dt, dt_bias, a_log, d, b, c) -> None:
    if state.dim() != 4:
        raise ValueError(f"want state [B,H,P,N]; got {tuple(state.shape)}")
    bsz, h, p, n = state.shape
    want = {"x": (bsz, h, p), "dt": (bsz, h), "dt_bias": (h,),
            "a_log": (h,), "d": (h,), "b": (bsz, n), "c": (bsz, n)}
    got = {"x": x, "dt": dt, "dt_bias": dt_bias, "a_log": a_log, "d": d,
           "b": b, "c": c}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name}: want {shape} for state "
                             f"{tuple(state.shape)}; got "
                             f"{tuple(got[name].shape)}")
    if state.dtype != torch.float32:
        raise TypeError(f"state must be float32, got {state.dtype}")
    dtypes = {t.dtype for t in got.values()}
    if len(dtypes) != 1 or x.dtype not in DTYPES:
        raise TypeError(f"x, dt, dt_bias, a_log, d, b and c must share one "
                        f"dtype of {DTYPES}; got {sorted(map(str, dtypes))}")
    if n not in STATE_DIMS:
        raise ValueError(f"state dim N={n} not in {STATE_DIMS}")
    if len({t.device for t in (state, *got.values())}) != 1:
        raise ValueError("the state and every input must be on one device")


def ssm_state_update(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                     dt_bias: torch.Tensor, a_log: torch.Tensor,
                     d: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """state [B,H,P,N] f32; x [B,H,P]; dt [B,H]; dt_bias, a_log, d [H];
    b, c [B,N] -> (y [B,H,P] f32, the new state).  On the card the new
    state is ``state`` itself, updated in place; elsewhere a new tensor.
    Raises RuntimeError, on every device, when grad is enabled and an
    input requires grad: there is no backward."""
    _check(state, x, dt, dt_bias, a_log, d, b, c)
    refuse_grad("ssm_state_update", state, x, dt, dt_bias, a_log, d, b, c)
    if state.device.type != "cuda":
        return ssm_state_update_ref(state, x, dt, dt_bias, a_log, d, b, c)
    return _launch(state, x, dt, dt_bias, a_log, d, b, c)


def _launch(state, x, dt, dt_bias, a_log, d, b, c):
    """Launch the kernel on checked CUDA tensors."""
    global launches
    bsz, h, p, n = state.shape
    if not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("state must be contiguous and 16-byte aligned")
    if x.stride()[1:] != (p, 1):
        raise ValueError(f"x must have heads P={p} apart and unit stride "
                         f"along P; got strides {x.stride()}")
    for name, t in (("dt", dt), ("b", b), ("c", c), ("dt_bias", dt_bias),
                    ("a_log", a_log), ("d", d)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along its last "
                             f"dim; got strides {t.stride()}")
    fn, err = _entry()
    y = torch.empty((bsz, h, p), dtype=torch.float32, device=state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    ptrs = (state.data_ptr(), x.data_ptr(), dt.data_ptr(), dt_bias.data_ptr(),
            a_log.data_ptr(), d.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr())
    with torch.cuda.device(state.device):
        rc = fn(*ptrs, bsz, h, p, n, x.stride(0), dt.stride(0), b.stride(0),
                c.stride(0), int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssm_state_update launch failed: "
                           f"{err(rc).decode()} (code {rc})")
    launches += 1
    launches_by_route["cuda"] += 1
    return y, state
