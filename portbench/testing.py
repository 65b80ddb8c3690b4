"""Helpers of the benchmark's own tests: its cells cut to a size the CPU
runs in seconds (the widths of the program's smoke configurations)."""

from __future__ import annotations

import time

import torch

from portbench import harness

#: widths of a cell cut for the CPU
SMALL = {"d_model": 64, "vocab": 512, "ssm_state": 16, "ssm_heads": 4,
         "ssm_chunk": 32}
SMALL_MIX = {"prompt_tokens": {"low": 8, "high": 40},
             "new_tokens": {"low": 3, "high": 9}}


def small_cell(name: str, limit: float = 0.2) -> harness.Cell:
    """Cell ``name`` of BENCHMARK.json at the CPU's size, three requests a
    batch, judged to ``limit``."""
    cell = harness.load_cell(name)
    m = cell.config["model"]
    m.update(SMALL, n_layers=3)
    cell.mix = dict(SMALL_MIX)
    cell.cell = dict(cell.cell, batch=3, mig_profile="7g.80gb",
                     check={"tokens": 24, "rows": 3, "limit": limit})
    return cell


def run_small(cell: harness.Cell, seed: int, seconds: float = 0.3,
              **kwargs) -> harness.Outcome:
    return harness.run(cell, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter(), **kwargs)
