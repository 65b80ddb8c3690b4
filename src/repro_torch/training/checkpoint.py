"""Checkpoints in the reference's format (``repro/training/checkpoint.py``):
a flat-key npz and a JSON manifest, pure numpy, so a state saved by either
package loads in the other.

- Keys are the tree's paths ``a/b/c``, stored in the npz as ``a__b__c``.
- bf16 is not npz-native: it is stored as uint16 bits, and the manifest's
  ``dtypes`` (numpy names, ``"bfloat16"`` among them) says which arrays
  to view back.
- The manifest ``<path>.manifest.json`` also holds the ``step``; the path
  gets ``.npz`` appended by numpy unless it already ends so.

The conversions between tensors and these arrays (:func:`to_numpy`,
:func:`to_tensor`) copy bits, so no value is rounded either way.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

SEP = "/"


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name the manifest records for a tensor dtype."""
    return str(dtype).removeprefix("torch.")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_tensor(arr: Any, device: str | torch.device = "cpu",
              dtype_name: str | None = None) -> torch.Tensor:
    """One numpy array as a tensor; ``dtype_name='bfloat16'`` marks 16-bit
    integer storage of bf16 values (the checkpoint format), and an array of
    ml_dtypes' bfloat16 (``jax.device_get``'s form) is taken as bf16."""
    arr = np.asarray(arr)
    # jax.device_get hands out read-only views; a copy keeps a 0-d array 0-d
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy(order="C")
    if arr.dtype.name == "bfloat16" or dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"bf16 storage must be 2 bytes, got {arr.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bytes (so NaNs and signed zeros count): what
    a checkpoint round trip must give back."""
    with torch.no_grad():
        return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.detach().reshape(-1).view(torch.uint8),
            b.detach().reshape(-1).view(torch.uint8)))


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves of a nested dict/list/tuple tree by their ``a/b/c`` path."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix.rstrip(SEP)] = tree
    return out


def save_checkpoint(path: str, state: Any, step: int | None = None) -> None:
    """Write ``state`` (a tree of tensors) to ``path`` (npz) and
    ``path + '.manifest.json'``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = flatten(state)
    dtypes = {k: dtype_name(v.dtype) for k, v in flat.items()}
    np.savez(path, **{k.replace(SEP, "__"): to_numpy(v)
                      for k, v in flat.items()})
    with open(path + ".manifest.json", "w") as f:
        json.dump({"step": step, "dtypes": dtypes}, f)


def read_checkpoint(path: str) -> tuple[dict[str, np.ndarray],
                                        dict[str, str], int | None]:
    """(arrays by ``a/b/c`` key, bf16 still as uint16; the manifest's
    dtypes; its step)."""
    with open(path + ".manifest.json") as f:
        manifest = json.load(f)
    with np.load(path if path.endswith(".npz") else path + ".npz") as raw:
        flat = {k.replace("__", SEP): raw[k] for k in raw.files}
    return flat, manifest["dtypes"], manifest["step"]


def load_checkpoint(path: str, skeleton: Any,
                    device: str | torch.device | None = None) -> Any:
    """The checkpoint as a tree shaped like ``skeleton`` (a tree of
    tensors, real or on the ``meta`` device).  Each leaf goes to ``device``,
    or to its skeleton leaf's device, and takes the skeleton leaf's
    ``requires_grad``; a key or shape that differs from the skeleton
    raises."""
    flat, dtypes, _ = read_checkpoint(path)
    want = flatten(skeleton)
    if set(flat) != set(want):
        raise ValueError(f"{path}: missing keys "
                         f"{sorted(set(want) - set(flat))}, unexpected keys "
                         f"{sorted(set(flat) - set(want))}")

    def load(key: str, like: torch.Tensor) -> torch.Tensor:
        t = to_tensor(flat[key], device if device is not None
                      else like.device, dtypes[key])
        if t.shape != like.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want "
                             f"{tuple(like.shape)}")
        return t.requires_grad_(like.requires_grad)

    return _unflatten({k: load(k, v) for k, v in want.items()}, skeleton)


def _unflatten(flat: dict[str, Any], skeleton: Any, prefix: str = "") -> Any:
    if isinstance(skeleton, dict):
        return {k: _unflatten(flat, v, f"{prefix}{k}{SEP}")
                for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(flat, v, f"{prefix}{i}{SEP}")
                              for i, v in enumerate(skeleton))
    return flat[prefix.rstrip(SEP)]
