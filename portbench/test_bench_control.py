"""The control comes out not correct: the reference with its weights in
8-bit floating point, in the program's place, reads wider gaps than the
program does, on the same rows."""

from __future__ import annotations

import json

import pytest

from portbench import calibrate, testing
from portbench.harness import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_wider_gaps_than_the_program(name):
    """At the CPU's size: the program's widest gap over three seeds is
    under a third of the control's narrowest."""
    program, control = [], []
    for seed in (1, 2, 3):
        out = testing.run_small(testing.small_cell(name), seed, control=True)
        program.append(out.checks["logit_gap"]["value"])
        control.append(out.control)
    assert 3 * max(program) <= min(control), (program, control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cells_limit_on_the_card(name):
    """At the cell's own size, on three seeds: the program within the
    cell's limit, the control beyond it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    limit = json.loads((ROOT / "portbench" / "cells"
                        / f"{name}.json").read_text())["check"]["limit"]
    for seed, gap, control, _ in calibrate.readings(name, [11, 12, 13]):
        assert gap <= limit < control, (seed, gap, control)
