"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU at a small size (the harness's
look for a card skipped: it runs on the CPU device), with one fault that a
serving cell can have planted in the program, and sees ``correct`` false:
a token altered where it is produced, a decode step that leaves its state
unchanged, half of the batch left out of the prefill.  The exchange
between chips does not exist on one chip.
"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import testing
from portbench.harness import ROOT
from repro_torch.models import registry, ssm
from repro_torch.models.module import tree_map
from repro_torch.serving.decode_graph import EagerDecode

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
#: decode steps of the warm-up batch, before the window
WARMUP_STEPS = 2


def judged(name: str, seed: int = 5) -> testing.harness.Outcome:
    cell = testing.small_cell(name)
    # every request of the window in the sample
    cell.cell["check"] = dict(cell.cell["check"], tokens=10 ** 6, rows=10 ** 6)
    return testing.run_small(cell, seed)


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    out = judged(name)
    assert out.correct, out.checks


@pytest.mark.parametrize("name", CELLS)
def test_a_token_altered_where_it_is_produced(name, monkeypatch):
    step = EagerDecode.step
    calls = []

    def altered(self, token, index):
        logits = step(self, token, index)
        calls.append(index)
        if len(calls) == WARMUP_STEPS + 3:
            logits = logits.clone()
            row = logits[0, -1]
            row[int(torch.argmin(row[:64]))] = row.max() + 1.0
        return logits

    monkeypatch.setattr(EagerDecode, "step", altered)
    out = judged(name)
    assert not out.correct, out.checks


@pytest.mark.parametrize("name", CELLS)
def test_a_decode_step_that_returns_its_state_unchanged(name, monkeypatch):
    decode = ssm.ssm_decode_step

    def stale(params, x, cache_conv, cache_state, cfg):
        out, _, _ = decode(params, x, cache_conv, cache_state, cfg)
        return out, cache_conv, cache_state

    monkeypatch.setattr(ssm, "ssm_decode_step", stale)
    out = judged(name)
    assert not out.correct, out.checks


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out_of_the_prefill(name, monkeypatch):
    prefill = registry.prefill_caches

    def half(params, cfg, tokens, caches):
        b = max(tokens.shape[0] // 2, 1)
        logits, _ = prefill(params, cfg, tokens[:b],
                            tree_map(lambda c: c[:, :b], caches))
        full = logits.new_zeros((tokens.shape[0],) + logits.shape[1:])
        full[:b] = logits
        return full, caches

    monkeypatch.setattr(registry, "prefill_caches", half)
    out = judged(name)
    assert not out.correct, out.checks
