"""The plain reference against the program, at the CPU's size: the
Mamba2 mixer, the whole model, and the engine's right-padded batches
judged as a run judges them."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import check, harness, testing, weights
from portbench.harness import ROOT
from portbench.reference import exact
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry, ssm
from repro_torch.models.module import cast_tree
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
#: two float32 computations of one function in other orders of summation
F32_TOL = 1e-4


def small_model(name: str, seed: int = 7):
    cell = testing.small_cell(name)
    m = cell.config["model"]
    cfg = dataclasses.replace(ModelConfig(**m), attn_impl="xla",
                              ssm_impl="xla")
    shapes, _ = registry.init_params(None, cfg, "meta")
    w = weights.make(shapes, cell.config["weights"], seed,
                     torch.device("cpu"))
    return cell.reference, m, cfg, w


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", CELLS)
def test_whole_model_logits_match_the_programs_forward(name):
    ref, m, cfg, w = small_model(name)
    tokens = torch.randint(0, m["vocab"], (2, 70),
                           generator=torch.Generator().manual_seed(1))
    want = registry.forward(cast_tree(w, torch.float32), cfg,
                            {"tokens": tokens}).logits[..., :m["vocab"]]
    x = ref.hidden(w, m, tokens)
    got = ref.logits(w, m, x.reshape(-1, x.shape[-1])).reshape(want.shape)
    assert rel(got, want.float()) < F32_TOL


def test_mamba_mixer_matches_the_programs_over_chunk_edges():
    ref, m, cfg, w = small_model(CELLS[0])
    lw = {k: v[1].float() for k, v in w["layers"].items()}
    h = torch.randn(3, 2 * ref.SSD_CHUNK + 5, m["d_model"],
                    generator=torch.Generator().manual_seed(2))
    assert rel(ref.mamba_mixer(lw, h, m, exact),
               ssm.ssm_forward(lw, h, cfg)) < F32_TOL


@pytest.mark.parametrize("name", CELLS)
def test_engine_tokens_on_ragged_prompts_lie_on_the_references_best(name):
    """The engine, on float32 weights, serves a batch whose prompts are
    right-padded to the longest; every token it chose (the prefill's first
    and the returned ones) is the reference's best but for rounding."""
    ref, m, cfg, w = small_model(name)
    cfg = dataclasses.replace(cfg, attn_impl="pallas", ssm_impl="pallas")
    w32 = cast_tree(w, torch.float32)
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, m["vocab"], n).astype(np.int32), k)
            for i, (n, k) in enumerate([(9, 6), (33, 4), (21, 8)])]
    engine = ServeEngine(cfg, w32, EngineConfig(max_batch=3, max_context=48,
                                                predict=False), device="cpu")
    prefills = harness.PrefillLogits(registry)
    try:
        registry.prefill_caches = prefills
        engine.run(reqs)
    finally:
        registry.prefill_caches = prefills.original
    first = harness.first_tokens(prefills.logits[0], m["vocab"])
    rows = [check.Chosen(r.prompt, 33, [f] + r.generated)
            for f, r in zip(first, reqs)]
    logits = check.logits_at(ref, w32, m, rows, torch.device("cpu"))
    assert check.widest_gap(logits, check.chosen_tokens(rows, "cpu")) < 1e-4
    assert [len(r.generated) for r in reqs] == [6, 4, 8]
