"""Minimal functional module system: parameters are nested dicts of tensors.

Every parameter carries a parallel *spec*, a tuple of logical axis names,
kept so that trees stay key-for-key comparable with the reference's.  Layer
stacks carry a leading ``layers`` axis; the port loops over it in Python.
"""

from __future__ import annotations

import math
from typing import Any

import torch

DEFAULT_DTYPE = torch.bfloat16
#: the most elements one normal draw takes at once (16 GiB of f32); above
#: it a tensor is drawn slice by slice (ParamBuilder._normal)
DRAW_LIMIT = 2 ** 32


class ParamBuilder:
    """Collects (params, specs) trees during init.

    Random values come from ``generator`` on ``device`` (the generator must
    live on that device).  On the ``meta`` device no numbers are drawn, so
    full-size shapes cost no memory.
    """

    def __init__(self, generator: torch.Generator | None,
                 device: str | torch.device = "cpu",
                 dtype: torch.dtype = DEFAULT_DTYPE) -> None:
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.params: dict[str, Any] = {}
        self.specs: dict[str, Any] = {}

    def add(self, name: str, shape: tuple[int, ...],
            axes: tuple[str | None, ...], init: str = "normal",
            scale: float | None = None,
            dtype: torch.dtype | None = None) -> None:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} vs axes {axes}")
        dtype = dtype or self.dtype
        if init == "zeros":
            value = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            value = torch.ones(shape, dtype=dtype, device=self.device)
        elif init == "normal":
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            value = self._normal(shape, scale, dtype)
        else:
            raise ValueError(init)
        self.params[name] = value
        self.specs[name] = tuple(axes)

    def _normal(self, shape: tuple[int, ...], scale: float,
                dtype: torch.dtype) -> torch.Tensor:
        """N(0, scale^2) drawn in f32 and cast.  A tensor of more than
        DRAW_LIMIT elements is drawn one slice of its leading axis at a
        time into its final dtype, so the f32 draw never holds it whole
        (gemma3-27b's stacked MLP weights are 7.2e9 elements: 28.7 GB in
        f32, twice over with the scaled copy); a slice still over the
        limit is itself drawn slice by slice (llama4-maverick's expert
        stack [layers, 128, 5120, 8192] has 5.4e9-element slices)."""
        gen = None if self.device.type == "meta" else self.generator

        def draw(part_shape):
            return (torch.randn(part_shape, generator=gen,
                                dtype=torch.float32, device=self.device)
                    * scale).to(dtype)

        if math.prod(shape) <= DRAW_LIMIT or len(shape) < 2:
            return draw(shape)
        # the fewest leading axes whose slices fit (slices stay at least 1-D)
        lead = 1
        while lead < len(shape) - 1 and math.prod(shape[lead:]) > DRAW_LIMIT:
            lead += 1
        value = torch.empty(shape, dtype=dtype, device=self.device)
        for part in value.view(-1, *shape[lead:]):
            part.copy_(draw(part.shape))
        return value

    def sub(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.generator, self.device, self.dtype)
        self.params[name] = child.params
        self.specs[name] = child.specs
        return child

    def build(self) -> tuple[dict, dict]:
        return self.params, self.specs


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict/list/tuple tree, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def param_count(params: Any) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def param_bytes(params: Any) -> int:
    return sum(p.numel() * p.element_size() for p in tree_leaves(params))


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(
        lambda x: x.to(dtype) if torch.is_floating_point(x) else x, tree)


def stack_specs(specs: Any) -> Any:
    """Prefix every spec in a layer's tree with the stacked 'layers' axis."""
    if isinstance(specs, dict):
        return {k: stack_specs(v) for k, v in specs.items()}
    return ("layers",) + tuple(specs)
