"""Logical-axis sharding rules -> DTensor placements.

The port's copy of the reference's ``repro/sharding/partitioning.py``: the
same rule tables, policies and greedy assignment, on a
:class:`torch.distributed.device_mesh.DeviceMesh` instead of a jax
``Mesh``.  The production meshes are

    ("data", "model")          — 16x16
    ("pod", "data", "model")   — 2x16x16

Parameters are tensor-parallel over "model" (heads / ffn / experts / vocab)
and FSDP-sharded over "data" on the embed dim; activations shard batch over
("pod", "data").  Every rule is divisibility-checked against the mesh so any
(arch x mesh) combination traces — non-divisible dims fall back to
replication (e.g. llama4's 40 heads on a 16-wide model axis).

:func:`spec_for` returns a plain tuple with the entries of the reference's
``PartitionSpec`` (``None``, a mesh axis name, or a tuple of names);
:func:`placements_for` turns it into one ``Shard(i)`` or ``Replicate()``
per mesh dim.  :func:`constrain` is the counterpart of
``with_sharding_constraint``: it redistributes a DTensor and hands any
other tensor back as it is, so the models' plain path never pays for it.
torch.distributed is imported only when a DTensor is met.
"""

from __future__ import annotations

import torch

# logical axis name -> preferred mesh axes, in priority order
PARAM_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": ("data",),          # FSDP / ZeRO-3 over the data axis
    "embed_no_fsdp": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    # fallback: when heads/kv_heads don't divide the model axis (llama4's 40
    # q heads, kv=8 on a 16-wide axis), shard the head_dim instead
    "head_dim": ("model",),
    "qkv": ("model",),           # fused q/k/v output dim
    "ffn": ("model",),
    "experts": ("model",),       # expert parallelism
    # fallback: grok's 8 experts don't divide a 16-wide model axis; shard
    # the expert FFN dim so expert weights never replicate
    "expert_ffn": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "layers": (),                # stacked leading axis
    "conv": (),
    "norm": (),
}

ACT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    # KV caches whose kv_heads don't divide the model axis shard their
    # context dim instead: decode attention then runs block-local with one
    # small [B,1,H,hd] reduction, instead of reducing full score rows
    # under head_dim sharding
    "cache_seq": ("model",),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ffn": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "vocab": ("model",),
    "capacity": (),
}

#: greedy assignment priority: earlier names claim mesh axes first,
#: regardless of their position in the value's axis tuple.
AXIS_PRIORITY = ("experts", "kv_heads", "heads", "ssm_inner", "ffn",
                 "expert_ffn", "vocab", "batch", "cache_seq", "head_dim",
                 "embed", "qkv", "seq", "capacity")

# -- named sharding POLICIES ----------------------------------------------------
#: each entry patches PARAM_RULES / ACT_RULES; selected per dry run via
#: ``--policy`` (python -m repro_torch.launch.perf).
POLICIES: dict[str, dict] = {
    "baseline": {"param": {}, "act": {}},
    # small models: drop FSDP — replicate params over 'data', keeping only
    # tensor parallelism; removes the per-microbatch weight all-gathers
    "no_fsdp": {"param": {"embed": ()}, "act": {}},
    # decode: weights are read once per token — FSDP gathers dominate the
    # step, so inference shards MoE expert_ffn over 'data' instead of
    # FSDP-sharding embed, and replicates the (small) attention weights
    "inference": {"param": {"embed": (), "expert_ffn": ("data", "model")},
                  "act": {}},
    # multi-pod MoE: experts spread over (model x pod) and the expert FFN
    # dim over data — expert weights are fully sharded with no d-dim FSDP,
    # so they are never all-gathered; tokens route via all-to-all instead.
    # Attention/dense weights replicate over data.
    "expert_pod": {"param": {"embed": (),
                             "experts": ("model", "pod"),
                             "expert_ffn": ("data",)},
                   "act": {}},
    # small models (<~2B): 16-way tensor parallelism only buys per-layer
    # activation reductions; keep TP on the vocab dim alone (logits/CE stay
    # sharded) and replicate everything else — the single grad all-reduce
    # per step is the only remaining sync
    "vocab_tp_only": {"param": {"embed": (), "heads": (), "kv_heads": (),
                                "head_dim": (), "ffn": (),
                                "ssm_inner": ()},
                      "act": {"batch": ("pod", "data", "model"),
                              "heads": (), "kv_heads": (), "head_dim": (),
                              "ffn": (), "ssm_inner": (),
                              "cache_seq": ("model",)}},
    # sequence parallelism for huge-model training: shard the residual
    # stream's seq dim over 'model'
    "seq_shard": {"param": {}, "act": {"seq": ("model",)}},
    # small models, final form: pure data parallelism over every mesh
    # axis — everything replicated, the per-step gradient all-reduce is the
    # only collective; microbatches bound the replicated logits
    "pure_dp": {"param": {"embed": (), "heads": (), "kv_heads": (),
                          "head_dim": (), "ffn": (), "ssm_inner": (),
                          "vocab": ()},
                "act": {"batch": ("pod", "data", "model"), "vocab": (),
                        "heads": (), "kv_heads": (), "head_dim": (),
                        "ffn": (), "ssm_inner": (), "cache_seq": ()}},
}


def apply_policy(policy: str) -> tuple[dict, dict]:
    p = POLICIES[policy]
    return ({**PARAM_RULES, **p["param"]}, {**ACT_RULES, **p["act"]})


#: rules consulted by in-model ``constrain`` calls; policies swap these at
#: trace time via :func:`active_act_rules` (tracing is single-threaded)
_ACTIVE_ACT_RULES: dict = ACT_RULES


class active_act_rules:
    """Context manager: make ``constrain`` use a policy's activation rules
    while a step is being traced."""

    def __init__(self, rules: dict) -> None:
        self.rules = rules

    def __enter__(self):
        global _ACTIVE_ACT_RULES
        self._saved = _ACTIVE_ACT_RULES
        _ACTIVE_ACT_RULES = self.rules
        return self

    def __exit__(self, *exc):
        global _ACTIVE_ACT_RULES
        _ACTIVE_ACT_RULES = self._saved
        return False


#: long-context decode (batch=1): shard the KV-cache context over "data"
LONG_CONTEXT_OVERRIDES = {
    "batch": (),
    "cache_seq": ("data",),
    "seq": ("data",),
}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(logical_axes: tuple[str | None, ...],
             mesh,
             dims: tuple[int, ...],
             rules: dict[str, tuple[str, ...]],
             overrides: dict[str, tuple[str, ...]] | None = None) -> tuple:
    """The partition spec of a value with the given logical axes: one
    entry per dim, ``None``, a mesh axis name or a tuple of names.

    Each logical axis maps to the mesh axes its rule names, filtered by
    (a) presence in the mesh, (b) divisibility of the dim, (c) not already
    used by an earlier axis of this value.
    """
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    out: list = [None] * len(logical_axes)

    def prio(item):
        axis = item[1][0]
        try:
            return AXIS_PRIORITY.index(axis)
        except ValueError:
            return len(AXIS_PRIORITY)

    indexed = [(i, (axis, dim)) for i, (axis, dim)
               in enumerate(zip(logical_axes, dims)) if axis is not None]
    for i, (axis, dim) in sorted(indexed, key=prio):
        wanted = (overrides or {}).get(axis, rules.get(axis, ()))
        chosen: list[str] = []
        shard = 1
        for m in wanted:
            if m not in sizes or m in used:
                continue
            if dim % (shard * sizes[m]) != 0:
                continue
            chosen.append(m)
            shard *= sizes[m]
            used.add(m)
        if chosen:
            out[i] = chosen[0] if len(chosen) == 1 else tuple(chosen)
    return tuple(out)


def placements_for(spec: tuple, mesh) -> list:
    """One ``Shard(i)`` or ``Replicate()`` per mesh dim for a
    :func:`spec_for` tuple; a mesh dim of one device replicates (the same
    local shard, and fewer sharded dims for DTensor's view rules).  A
    tensor dim that takes several mesh axes is
    sharded over each of them; DTensor splits such a dim over the mesh
    dims in mesh order, which is the spec's major-to-minor order for every
    rule but ``expert_pod``'s ("model", "pod") (same local shard shape,
    another assignment of shards to devices)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            if mesh.shape[names.index(axis)] > 1:   # one device: replicated
                out[names.index(axis)] = Shard(i)
    return out


def act_spec(logical_axes, mesh, dims, long_context=False) -> tuple:
    ov = LONG_CONTEXT_OVERRIDES if long_context else None
    return spec_for(tuple(logical_axes), mesh, tuple(dims),
                    _ACTIVE_ACT_RULES, ov)


def constrain(x, logical_axes, mesh=None, long_context=False):
    """Redistribute a DTensor to the active activation rules; any other
    tensor comes back unchanged (the same object)."""
    if type(x) is torch.Tensor or not _is_dtensor(x):
        return x
    mesh = mesh if mesh is not None else x.device_mesh
    placements = placements_for(
        act_spec(logical_axes, mesh, x.shape, long_context), mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def unflatten(x, dim: int, sizes: tuple[int, ...]):
    """``x.unflatten(dim, sizes)``.  A DTensor keeps a shard of ``dim``
    only on the leading factor, so one sharded there over more devices
    than ``sizes[0]`` splits into is first gathered on that dim (the
    reference's XLA inserts the same collective); its gradient merges back
    through :func:`flatten`.  Any other tensor is unflattened as it is."""
    if type(x) is torch.Tensor or not _is_dtensor(x):
        return x.unflatten(dim, sizes)
    return _Unflatten.apply(x, dim % x.ndim, tuple(sizes))


def flatten(x, start: int, end: int):
    """``x.flatten(start, end)``.  A DTensor keeps a shard through the
    merge only on the leading dim of the range, so a shard of a later dim
    is first gathered; its gradient splits back through :func:`unflatten`.
    Any other tensor is flattened as it is."""
    if type(x) is torch.Tensor or not _is_dtensor(x):
        return x.flatten(start, end)
    return _Flatten.apply(x, start % x.ndim, end % x.ndim)


def einsum(equation: str, a, b):
    """``torch.einsum(equation, a, b)``.  Two DTensors sharded only on
    batch letters (letters of both operands and of the output) are
    contracted shard by shard through ``local_map``: the product is
    independent along a batch letter, so the local einsum is the sharded
    result.  Where one operand is sharded on a batch letter along a mesh
    dim and the other is replicated or partial there, the other is first
    redistributed to the same shard (a local slice, or the reduce-scatter
    that DTensor's own rule picks).  DTensor's own rule instead merges the
    batch dims, which torch 2.11 refuses with a shard on any but the
    first.  Any other pair goes to ``torch.einsum`` as it is."""
    if type(a) is torch.Tensor or not (_is_dtensor(a) and _is_dtensor(b)):
        return torch.einsum(equation, a, b)
    plan = _batch_local_plan(equation, a, b)
    if plan is None:
        return torch.einsum(equation, a, b)
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    to_a, to_b, out = plan
    a = a if tuple(a.placements) == to_a else a.redistribute(mesh, to_a)
    b = b if tuple(b.placements) == to_b else b.redistribute(mesh, to_b)
    return local_map(lambda x, y: torch.einsum(equation, x, y),
                     out_placements=out, in_placements=(to_a, to_b),
                     device_mesh=mesh)(a, b)


def _batch_local_plan(equation: str, a, b):
    """(a's placements, b's placements, the output's) of :func:`einsum`'s
    local path, or None where it does not apply: a mesh dim sharding the
    two on different letters, either on a letter that is not a batch
    letter, partial in both or partial against replicated, or a batch
    letter that its shards do not split evenly."""
    from torch.distributed.tensor import Shard
    ins, res = equation.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    if a.device_mesh != b.device_mesh or "." in equation:
        return None
    mesh = a.device_mesh
    to_a, to_b, out, ways = [], [], [], {}
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        la = ia[pa.dim] if pa.is_shard() else None
        lb = ib[pb.dim] if pb.is_shard() else None
        if pa.is_replicate() and pb.is_replicate():
            to_a.append(pa)
            to_b.append(pb)
            out.append(pa)
            continue
        letter = la or lb
        if (letter is None or (la and lb and la != lb)
                or not (letter in ib and letter in ia and letter in res)):
            return None
        ways[letter] = ways.get(letter, 1) * mesh.size(i)
        to_a.append(Shard(ia.index(letter)))
        to_b.append(Shard(ib.index(letter)))
        out.append(Shard(res.index(letter)))
    for letter, n in ways.items():
        if a.shape[ia.index(letter)] % n:
            return None
    return tuple(to_a), tuple(to_b), out


def lookup(table, tokens):
    """``table[tokens]``, the rows of a [vocab, d] table.  A DTensor table
    is looked up shard by shard through ``local_map``, on the plan that
    torch 2.13's DTensor rule for ``aten.index`` picks: along a mesh dim
    that shards the vocab, the table is resharded onto its d dim (one
    all-to-all of the local shard); along one that shards d, it stays;
    along either, the tokens are replicated and the rows come out sharded
    on d.  Along a mesh dim that replicates the table, the tokens keep
    their shard and the rows come out sharded as they are.  Torch 2.11's
    rule instead gathers the whole table.  Any other pair is indexed as it
    is."""
    if type(table) is torch.Tensor or not (_is_dtensor(table)
                                           and _is_dtensor(tokens)):
        return table[tokens]
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    to_table, to_tokens, out = [], [], []
    for pt, px in zip(table.placements, tokens.placements):
        if pt.is_replicate():
            to_table.append(pt)
            to_tokens.append(px)
            out.append(px)
        else:
            to_table.append(Shard(1) if pt.is_shard() else pt)
            to_tokens.append(Replicate())
            out.append(Shard(tokens.ndim) if pt.is_shard() else pt)
    to_table, to_tokens = tuple(to_table), tuple(to_tokens)
    if tuple(table.placements) != to_table:
        table = table.redistribute(mesh, to_table)
    if tuple(tokens.placements) != to_tokens:
        tokens = tokens.redistribute(mesh, to_tokens)
    return local_map(lambda t, x: t[x], out_placements=out,
                     in_placements=(to_table, to_tokens),
                     device_mesh=mesh)(table, tokens)


def index_add(x, dim: int, index, source):
    """``x.index_add_(dim, index, source)``, in place, returning x; a
    DTensor gets the out-of-place ``index_add`` instead (DTensor's
    in-place rule relabels the placements without moving the shard)."""
    if type(x) is torch.Tensor or not _is_dtensor(x):
        return x.index_add_(dim, index, source)
    return x.index_add(dim, index, source)


def _replicate_where(x, sharded: list[bool]):
    from torch.distributed.tensor import Replicate
    if not any(sharded):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if s else p for p, s in zip(x.placements, sharded)])


class _Unflatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.n = dim, len(sizes)
        on_dim = [p.is_shard(dim) for p in x.placements]
        n = 1
        for size, sharded in zip(x.device_mesh.shape, on_dim):
            n *= size if sharded else 1
        if sizes[0] % n:
            x = _replicate_where(x, on_dim)
        return x.unflatten(dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return flatten(g, ctx.dim, ctx.dim + ctx.n - 1), None, None


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, start, end):
        ctx.start, ctx.sizes = start, tuple(x.shape[start:end + 1])
        x = _replicate_where(x, [
            any(p.is_shard(d) for d in range(start + 1, end + 1))
            for p in x.placements])
        return x.flatten(start, end)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.start, ctx.sizes), None, None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)

