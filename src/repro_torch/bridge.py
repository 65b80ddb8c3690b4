"""Reference parameters and caches -> the port's tensors.

The reference keeps params as nested dicts of arrays; ``jax.device_get``
turns them into nested dicts of numpy arrays, bf16 as ml_dtypes' bfloat16.
These functions take that form, or the flat ``a/b/c`` key form of the
reference's checkpoints (``repro/training/checkpoint.py::_flatten``), check
every key and shape against the port's own tree for the config, and return
nested dicts of tensors.  bf16 arrays are viewed as 16-bit integers and
then as ``torch.bfloat16``, so no value is rounded on the way.  Only numpy
is needed: the reference package is never imported.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.module import tree_map
from repro_torch.training.checkpoint import SEP, read_checkpoint, to_tensor


def _nest(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _is_flat(tree: Mapping) -> bool:
    return any(SEP in k for k in tree)


def _convert(tree: Any, expected: Any, device, path: str,
             dtypes: Mapping[str, str]) -> Any:
    if isinstance(expected, dict):
        if not isinstance(tree, Mapping):
            raise ValueError(f"{path or '<root>'}: expected a dict")
        missing = sorted(set(expected) - set(tree))
        extra = sorted(set(tree) - set(expected))
        if missing or extra:
            raise ValueError(f"{path or '<root>'}: missing keys {missing}, "
                             f"unexpected keys {extra}")
        return {k: _convert(tree[k], v, device, f"{path}{k}{SEP}", dtypes)
                for k, v in expected.items()}
    key = path.rstrip(SEP)
    t = to_tensor(tree, device, dtypes.get(key))
    if tuple(t.shape) != tuple(expected.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)}, the port expects "
                         f"{tuple(expected.shape)}")
    return t


def _from_numpy(tree: Mapping, expected: dict, device,
                dtypes: Mapping[str, str] | None = None) -> dict:
    if _is_flat(tree):
        tree = _nest(tree)
    return _convert(tree, expected, torch.device(device), "", dtypes or {})


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: str | torch.device = "cpu") -> dict:
    """Reference params (nested or flat numpy) -> the port's param dict."""
    expected, _ = registry.init_params(None, cfg, device="meta")
    return _from_numpy(tree, expected, device)


def caches_from_numpy(tree: Mapping, cfg: ModelConfig, batch: int,
                      context: int,
                      device: str | torch.device = "cpu") -> dict:
    """Reference KV caches (nested or flat numpy) -> the port's caches."""
    expected = registry.init_caches(cfg, batch, context, device="meta")
    return _from_numpy(tree, expected, device)


def state_from_numpy(tree: Mapping, cfg: ModelConfig,
                     device: str | torch.device = "cpu") -> dict:
    """A reference train state (``jax.device_get`` of ``{"params", "opt":
    {"m", "v", "step"}}``) -> the port's train state: params that require
    grad, the moments in their own dtype, ``step`` an int32 scalar."""
    expected, _ = registry.init_params(None, cfg, device="meta")
    params = tree_map(lambda p: p.requires_grad_(),
                      _from_numpy(tree["params"], expected, device))
    opt = tree["opt"]
    return {"params": params, "opt": {
        "m": _from_numpy(opt["m"], expected, device),
        "v": _from_numpy(opt["v"], expected, device),
        "step": to_tensor(opt["step"], device),
    }}


def load_npz_params(path: str, cfg: ModelConfig,
                    device: str | torch.device = "cpu") -> dict:
    """Params from a checkpoint of either package
    (:func:`repro_torch.training.checkpoint.save_checkpoint`'s npz plus its
    ``.manifest.json``), whose state holds them under ``params``."""
    flat, dtypes, _ = read_checkpoint(path)
    prefix = "params" + SEP
    flat = {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}
    dtypes = {k[len(prefix):]: v for k, v in dtypes.items()
              if k.startswith(prefix)}
    expected, _ = registry.init_params(None, cfg, device="meta")
    return _from_numpy(flat, expected, device, dtypes)
