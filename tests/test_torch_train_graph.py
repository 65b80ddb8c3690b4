"""The train step as the captured CUDA graph runs it
(``training/train_graph.py``), on the CPU, and the dry run's embedding
lookup on a vocab-sharded table (``sharding/partitioning.py::lookup``).

* :class:`EagerTrain` (the captured step's body run op by op, gradients in
  buffers it owns, zeroed in place) equals ``train_step`` bit for bit, for
  every smoke config, with one and two microbatches: metrics and every
  leaf of params, moments and the step counter (``train_step`` is held to
  the reference's jitted train step in ``tests/test_torch_training.py``);
* the step reads no device value on the host: run on ``meta`` tensors
  (standing for the card's) under ``RefuseHostReads`` from
  ``tests/test_torch_decode_graph.py``, which raises on every op that a
  CUDA graph capture refuses; the gradient buffers stay pinned where the
  old ``p.grad = None`` discipline drops them;
* :class:`TrainGraph` refuses the CPU and ``trainer_for`` picks by device.
  The graph itself runs only on the card (``tests/test_torch_cuda.py``,
  chip_smoke's phase 6).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_decode_graph import HostRead, RefuseHostReads

from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.models.layers import _Lookup
from repro_torch.models.module import tree_leaves
from repro_torch.training.checkpoint import flatten, same_bits
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_graph import (EagerTrain, TrainGraph,
                                              trainer_for)
from repro_torch.training.train_step import init_train_state, train_step

REPO = Path(__file__).resolve().parents[1]
B, S, STEPS = 2, 16, 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS)


def _state(cfg, device="cpu"):
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    return init_train_state(gen, cfg, device=device)


def _clone(state):
    out = {k: v.detach().clone() for k, v in flatten(state).items()}
    for k in out:
        if k.startswith("params/"):
            out[k].requires_grad_()
    return _unflatten(out)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _data(cfg):
    return SyntheticLM(cfg, DataConfig(B, S, seed=3))


# -- the step's body against train_step ---------------------------------------


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_eager_train_equals_train_step_bit_for_bit(arch, n_microbatches):
    cfg = get_smoke_config(arch)
    ours = _state(cfg)
    theirs = _clone(ours)
    data = _data(cfg)
    trainer = EagerTrain(ours, cfg, OPT, data.shapes(), n_microbatches)
    for _, batch in zip(range(STEPS), data.batches()):
        got = trainer.step(batch)
        _, want = train_step(theirs, batch, cfg=cfg, opt_cfg=OPT,
                             n_microbatches=n_microbatches)
        assert set(got) == set(want) == {"loss", "aux_loss", "grad_norm",
                                         "lr"}
        for k in want:
            assert same_bits(got[k], want[k]), k
    a, b = flatten(ours), flatten(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        assert same_bits(a[k].detach(), b[k].detach()), k


# -- what a capture needs ------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_the_captured_step_reads_no_device_value_on_the_host(arch):
    """Two microbatches, per-layer checkpointing and the AdamW update, on
    ``meta``."""
    cfg = get_smoke_config(arch)
    state = _state(cfg, "meta")
    shapes = _data(cfg).shapes()
    batch = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in shapes.items()}
    trainer = EagerTrain(state, cfg, OPT, shapes, n_microbatches=2)
    with RefuseHostReads():
        metrics = trainer.step(batch)
    assert all(v.shape == () and v.device.type == "meta"
               for v in metrics.values())
    assert int(torch.count_nonzero(torch.ones(1))) == 1   # the mode is off


def test_the_mode_refuses_a_step_that_reads_its_loss():
    cfg = get_smoke_config("qwen3-0.6b")
    shapes = _data(cfg).shapes()
    trainer = EagerTrain(_state(cfg, "meta"), cfg, OPT, shapes)
    run = trainer._run
    trainer._run = lambda batch: {"loss": float(run(batch)["loss"])}
    batch = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in shapes.items()}
    with pytest.raises(HostRead, match="_local_scalar_dense"), \
            RefuseHostReads():
        trainer.step(batch)


def test_gradient_buffers_stay_pinned_where_train_step_drops_them():
    """The trainer's gradients are the params' ``.grad`` after every step,
    at the same addresses, as a replay needs them; ``train_step`` sets
    every ``.grad`` to None after its step, which would drop them, and the
    trainer's next step attaches its own again."""
    cfg = get_smoke_config("qwen3-0.6b")
    state = _state(cfg)
    data = _data(cfg)
    batches = data.batches()
    trainer = EagerTrain(state, cfg, OPT, data.shapes())
    ptrs = [g.data_ptr() for g in trainer.grads]
    leaves = tree_leaves(state["params"])
    trainer.step(next(batches))
    assert all(p.grad is g for p, g in zip(leaves, trainer.grads))
    assert any(bool(g.any()) for g in trainer.grads)
    train_step(state, next(batches), cfg=cfg, opt_cfg=OPT)
    assert all(p.grad is None for p in leaves)
    trainer.step(next(batches))
    assert all(p.grad is g for p, g in zip(leaves, trainer.grads))
    assert [g.data_ptr() for g in trainer.grads] == ptrs


def test_train_graph_refuses_the_cpu_and_trainer_for_picks_by_device():
    cfg = get_smoke_config("qwen3-0.6b")
    state = _state(cfg)
    shapes = _data(cfg).shapes()
    with pytest.raises(ValueError, match="on the card"):
        TrainGraph(state, cfg, OPT, shapes)
    trainer = trainer_for(state, cfg, OPT, shapes, 1, torch.device("cpu"))
    assert type(trainer) is EagerTrain
    with pytest.raises(ValueError, match="lies on cpu"):
        trainer_for(state, cfg, OPT, shapes, 1, torch.device("cuda"))


def test_a_batch_of_another_shape_is_refused():
    cfg = get_smoke_config("qwen3-0.6b")
    data = _data(cfg)
    trainer = EagerTrain(_state(cfg), cfg, OPT, data.shapes())
    batch = next(data.batches())
    with pytest.raises(ValueError, match="is not the trainer's"):
        trainer.step({k: v[:1] for k, v in batch.items()})


@pytest.mark.parametrize("arch", ["whisper-medium", "pixtral-12b",
                                  "qwen3-0.6b"])
def test_synthetic_lm_shapes_are_its_batches(arch):
    data = _data(get_smoke_config(arch))
    batch = next(data.batches())
    assert data.shapes() == {k: (tuple(v.shape), v.dtype)
                             for k, v in batch.items()}


# -- the embedding lookup (ROADMAP queue 3, fault 4) -------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_on_plain_tensors_is_unchanged_bit_for_bit(dtype):
    """Forward ``table[tokens]``; backward each row's gradient summed in
    f32 and rounded once, with tokens repeated in the batch."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((40, 8), dtype=np.float32)
                             ).to(dtype).requires_grad_()
    tokens = torch.from_numpy(rng.integers(0, 6, (3, 7)))
    grad = torch.from_numpy(rng.standard_normal((3, 7, 8), dtype=np.float32)
                            ).to(dtype)
    out = _Lookup.apply(table, tokens)
    assert same_bits(out.detach(), table.detach()[tokens])
    out.backward(grad)
    want = torch.zeros((40, 8), dtype=torch.float32).index_add_(
        0, tokens.reshape(-1), grad.reshape(-1, 8).float()).to(dtype)
    assert same_bits(table.grad, want)


LOOKUP_WORLD = """
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_count import analyze, local, local_nbytes
from repro_torch.launch.shapes import SHAPES
from repro_torch.sharding.partitioning import apply_policy, lookup
mesh = make_production_mesh()
prules, arules = apply_policy("baseline")
batch = SHAPES["decode_32k"].batch
out = {}
for arch in sys.argv[1:]:
    cfg = get_config(arch)
    params, specs = dryrun._param_state(cfg)
    table = dryrun._shard_tree(params["embedding"], specs["embedding"], mesh,
                               prules, False)
    tokens = dryrun._shard_tree(
        torch.empty((batch, 1), dtype=torch.int64, device="meta"),
        ("batch", None), mesh, arules, False)
    res = {}
    got = analyze(lambda t, x: res.setdefault("rows", lookup(t, x)), table,
                  tokens, sites=True)
    out[arch] = {"collectives": {k: v for k, v in got["collectives"].items()
                                 if k != "counts"},
                 "counts": got["collectives"]["counts"],
                 "sites": got["sites"], "largest": got["largest"],
                 "table": [p.dim if p.is_shard() else str(p)
                           for p in table.placements],
                 "rows": [p.dim if p.is_shard() else str(p)
                          for p in res["rows"].placements],
                 "rows_local": list(local(res["rows"]).shape),
                 "table_bytes": table.numel() * table.element_size(),
                 "table_local_bytes": local_nbytes(table),
                 "token_bytes": tokens.numel() * tokens.element_size()}
print(json.dumps(out))
"""

LOOKUP_ARCHS = ("gemma3-27b", "zamba2-7b", "whisper-medium")


@pytest.fixture(scope="module")
def lookup_world():
    res = subprocess.run(
        [sys.executable, "-c", LOOKUP_WORLD, *LOOKUP_ARCHS], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin")},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", LOOKUP_ARCHS)
def test_lookup_on_a_vocab_sharded_table_gathers_no_table(lookup_world,
                                                          arch):
    """decode_32k's lookup on the 16x16 production mesh of a fake process
    group, its collectives counted at that one site: the table, vocab on
    "model" and d on "data", is resharded onto d along "model" (one
    all-to-all of the local shard), the tokens gathered along "data", and
    the rows come out sharded on d along both; nothing gathers the table.
    Torch 2.13 (the CPU tests') picks the same plan for ``table[tokens]``
    itself, so it shows no gather with or without the fix; torch 2.11
    gathers the whole table there, and chip_smoke's phase 11(a2) proves
    the fix on the card's torch 2.11.  ``DECODE_32K_PINNED``
    (tests/test_torch_dryrun.py) holds the whole trace's figures."""
    got = lookup_world[arch]
    assert got["table"] == [1, 0]          # shard dims along data, model
    assert got["rows"] == [2, 2]
    assert got["collectives"] == {
        "all-gather": got["token_bytes"], "all-reduce": 0,
        "reduce-scatter": 0, "all-to-all": got["table_local_bytes"],
        "collective-permute": 0,
        "total": got["token_bytes"] + got["table_local_bytes"],
        "alltoall_as_allgather_bytes": 16 * got["table_local_bytes"]}
    assert got["counts"]["all-gather"] == 1
    assert got["counts"]["all-to-all"] == 1
    assert got["sites"] == {
        "all-gather | partitioning.py::lookup": got["token_bytes"],
        "all-to-all | partitioning.py::lookup": got["table_local_bytes"]}
    assert got["largest"]["all-gather"] == got["token_bytes"]
    assert got["table_local_bytes"] * 256 == got["table_bytes"]
