"""Wrapper of the hand-written Hopper flash-attention kernel.

``flash_attention`` takes the kernel layout (q [B,H,Sq,D], k/v [B,KH,Sk,D])
and computes causal / sliding-window / GQA softmax attention in f32, with
the output in q's dtype.  A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.attention_ref`); a CUDA tensor goes to the
kernel in ``csrc/flash_attention.cu``, or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

#: q rows per tile and keys per KV tile in the kernel; Sq and Sk must be
#: multiples of it (kernels/ops.flash_mha pads)
BLOCK = 64
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches in this process; only CUDA calls count
launches = 0


@functools.cache
def _entry():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = lib.flash_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


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

    Keys at positions >= ``kv_len`` (default Sk) are hidden.
    """
    global launches
    kv_len = k.shape[2] if kv_len is None else kv_len
    _check(q, k, v, window, kv_len)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    fn, err = _entry()
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, kh, sq, sk, d, kv_len, int(causal), window or 0,
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    launches += 1
    return out
