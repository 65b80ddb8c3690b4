"""Wrapper of the hand-written Hopper flash-attention kernels.

``flash_attention`` takes the kernel layout (q [B,H,Sq,D], k/v [B,KH,Sk,D])
and computes causal / sliding-window / GQA softmax attention in f32, with
the output in q's dtype.  A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.attention_ref`).  A CUDA tensor goes to one
of two kernels, by :func:`route`, a function of dtype and head dim alone
decided before the launch:

- ``"sm90"``: bf16 at D in ``SM90_HEAD_DIMS`` (64, 112, 128, 256) goes to
  ``csrc/flash_attention_sm90.cu`` (bf16 ``wgmma`` fed by TMA; D=112 runs
  on its 128-column code with the last 16 columns zero-filled by TMA;
  D=256, gemma-2b's, on its own instantiation, one block an SM).  It
  takes q/k/v views with D contiguous and the other strides multiples of
  16 bytes, and returns a [B,H,Sq,D] view of a [B,Sq,H,D] buffer;
- ``"simt"``: every other pair (f32 at D 32/64/112/128/256, bf16 at 32)
  goes to ``csrc/flash_attention.cu`` (CUDA-core f32 products, as f32
  parity at 2e-5 needs).  It takes contiguous q/k/v.

A failed build or launch on either route raises; no call is retried on
the other kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.ref import attention_ref

#: q rows per tile and keys per KV tile in the kernel; Sq and Sk must be
#: multiples of it (kernels/ops.flash_mha pads)
BLOCK = 64
HEAD_DIMS = (32, 64, 112, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
#: head dims the bf16 wgmma kernel takes
SM90_HEAD_DIMS = (64, 112, 128, 256)
ROUTES = ("sm90", "simt")

#: kernel launches in this process, in all and by route, and of them the
#: launches with a sliding window; only CUDA calls count
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
windowed_launches = 0


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of this dtype and head dim goes to."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


@functools.cache
def _entry(route_name: str):
    if route_name == "sm90":
        lib = build.load("flash_attention_sm90")
        fn = lib.flash_attention_sm90_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        err = lib.flash_attention_sm90_error_string
    else:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        err = lib.flash_attention_error_string
    fn.restype = ctypes.c_int
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def tma_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """Element strides (batch, head, position) of a [B,N,S,D] view for the
    sm90 kernel's tensor maps; raises unless D is contiguous and every
    stride that is walked, and the base address, are multiples of 16
    bytes.  A dimension of size 1 is never walked, so its stride is
    reported as the position stride times S."""
    if x.stride(3) != 1:
        raise ValueError(f"the sm90 route needs D contiguous; strides "
                         f"{tuple(x.stride())}")
    unit = 16 // x.element_size()
    strides = tuple(x.stride(i) if x.shape[i] > 1
                    else x.stride(2) * x.shape[2] for i in range(3))
    if any(st % unit for st in strides) or x.data_ptr() % 16:
        raise ValueError(f"the sm90 route needs strides and base address "
                         f"in multiples of 16 bytes; strides "
                         f"{tuple(x.stride())}")
    return strides


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, kv_len: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,H,Sq,D], k/v [B,KH,Sk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, kh, sk, dk = k.shape
    if bk != b or dk != d or kh == 0 or h % kh:
        raise ValueError(f"incompatible q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if sq % BLOCK or sk % BLOCK:
        raise ValueError(f"Sq={sq} and Sk={sk} must be multiples of {BLOCK}")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} outside [0, {sk}]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    kv_len: int | None = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k/v: [B,KH,Sk,D] -> [B,H,Sq,D] in q's dtype.

    Keys at positions >= ``kv_len`` (default Sk) are hidden.  On the sm90
    route the result is a view of a [B,Sq,H,D] buffer.  Raises
    RuntimeError, on every device, when grad is enabled and an input
    requires grad: there is no backward.
    """
    kv_len = k.shape[2] if kv_len is None else kv_len
    _check(q, k, v, window, kv_len)
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    return _launch(route(q.dtype, q.shape[3]), q, k, v, causal=causal,
                   window=window, kv_len=kv_len)


def _launch(route_name: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, *, causal: bool, window: int | None,
            kv_len: int) -> torch.Tensor:
    """Launch the named route's kernel on checked CUDA tensors."""
    global launches, windowed_launches
    fn, err = _entry(route_name)
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route_name == "sm90":
        strides = [st for x in (q, k, v) for st in tma_strides(x)]
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, h, kh, sq, sk, d, *strides, kv_len, int(causal),
                    window or 0, stream)
        out = out.transpose(1, 2)
    else:
        if not (q.is_contiguous() and k.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("the simt route needs q, k and v contiguous")
        # the kernel stages by 16-byte cp.async: a view at another offset
        # is copied to a fresh buffer
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, h, kh, sq, sk, d, kv_len, int(causal), window or 0,
                    int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route_name}) launch failed: "
                           f"{err(rc).decode()} (code {rc})")
    launches += 1
    launches_by_route[route_name] += 1
    if window is not None:
        windowed_launches += 1
    return out
