"""The weights of a configuration, made on the device from the seed.

The tree has the layout the served program takes (its names and shapes are
read from the program's own initialiser on the ``meta`` device, which
draws nothing); every number in it is drawn here, by the rules of the
configuration file's ``weights`` block, keyed by a leaf's name:

- ``{"kind": "normal", "fan_in": [dims]}``: N(0, 1 / fan_in), fan_in the
  product of those dimensions of the leaf (negative indices, so a stacked
  leaf counts as one layer's);
- ``{"kind": "ones"}``, ``{"kind": "zeros"}``;
- ``{"kind": "log_uniform_log", "low": a, "high": b}``: log of U(a, b)
  (Mamba2's A_log);
- ``{"kind": "softplus_inverse_log_uniform", "low": a, "high": b,
  "floor": f}``: the dt bias whose softplus is log-uniform in [a, b],
  floored at f (Mamba2's dt_bias).

The normal leaves share one buffer in the served dtype, filled by a few
large ``normal_`` calls from a ``torch.Generator`` on the device and scaled
leaf by leaf in place.
"""

from __future__ import annotations

import math

import torch

#: leaves start at multiples of this many elements in the shared buffer
ALIGN = 256
#: the most elements one normal_ call fills
DRAW_CHUNK = 2 ** 30


def leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def put(tree: dict, path: tuple, value: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(shapes: dict, rules: dict, seed: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """A tree shaped as ``shapes`` (a tree of tensors whose shapes count,
    such as ``meta`` tensors) drawn from ``seed`` by ``rules``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    spec = leaves(shapes)
    unknown = sorted({p[-1] for p, _ in spec} - set(rules))
    if unknown:
        raise KeyError(f"no weight rule for leaves {unknown}")
    offsets, total = {}, 0
    for path, t in spec:
        if rules[path[-1]]["kind"] == "normal":
            offsets[path] = total
            total += -(-t.numel() // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    for lo in range(0, total, DRAW_CHUNK):
        buf[lo:lo + DRAW_CHUNK].normal_(generator=gen)
    out: dict = {}
    for path, t in spec:
        rule, shape = rules[path[-1]], tuple(t.shape)
        kind = rule["kind"]
        if kind == "normal":
            fan_in = math.prod(shape[i] for i in rule["fan_in"])
            value = buf[offsets[path]:offsets[path] + math.prod(shape)]
            value = value.view(shape).mul_(1.0 / math.sqrt(fan_in))
        elif kind == "ones":
            value = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            value = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "log_uniform_log":
            u = torch.rand(shape, generator=gen, device=device)
            value = torch.log(rule["low"] + u * (rule["high"] - rule["low"]))
        elif kind == "softplus_inverse_log_uniform":
            u = torch.rand(shape, generator=gen, device=device)
            lo, hi = math.log(rule["low"]), math.log(rule["high"])
            dt = torch.exp(lo + u * (hi - lo)).clamp(min=rule["floor"])
            value = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"{path}: unknown weight rule {kind!r}")
        put(out, path, value.to(dtype))
    return out
