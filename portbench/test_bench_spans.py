"""The readers of the engine's spans (``decode_gap_ms``,
``memory_check_us``, ``decode_row_use_pct``) on hand-built timelines,
without the spans (a program that records none), and on a traced run of
a small cell on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import devtrace, harness, testing

US = 1_000   # ns
READERS = ("decode_gap_ms", "memory_check_us", "decode_row_use_pct")


def step(t: int, sync_us: int, memory_us: int) -> list[tuple[str, int, int]]:
    """One decode step's spans from ``t`` (µs): a 10 µs launch, the sync,
    a 5 µs token append and the memory check."""
    names = ("launch", "sync", "tokens", "memory")
    out, at = [], t
    for name, took in zip(names, (10, sync_us, 5, memory_us)):
        out.append(("repro_torch.serve." + name, at * US, (at + took) * US))
        at += took
    return out


def records(host, ops, batches, generated) -> harness.Records:
    trace = devtrace.Trace(sorted(ops, key=lambda o: o[1]), [], batches,
                           host)
    return harness.Records(trace, [harness.Batch([5] * len(g), g, 5, len(g))
                                   for g in generated], {}, None)


def timeline(outside: bool = False) -> harness.Records:
    """A batch [0, 1000) µs of three steps of four rows.  Step one's sync
    ends at 130 µs, step two's at 310 µs, step three's at 490 µs (the
    last: no next step); the device's next operations start 20 and 40 µs
    after the first two.  The memory checks take 30, 50 and 70 µs.  With
    ``outside``, a second batch [2000, 3000) µs of one step, and a step's
    spans between the two batches, which no reader may count."""
    host = [("repro_torch.serve.run", 10 * US, 990 * US),
            ("aten::copy_", 100 * US, 105 * US)]
    host += step(100, 20, 30) + step(265, 35, 50) + step(390, 90, 70)
    ops = [("graph", 105 * US, 128 * US), ("fill", 150 * US, 151 * US),
           ("graph", 152 * US, 300 * US), ("graph", 350 * US, 480 * US)]
    batches, generated = [(0, 1000 * US)], [[3, 1, 2, 2]]
    if outside:
        host += step(1500, 10, 999)
        host += step(2100, 30, 10)
        ops += [("graph", 1505 * US, 1515 * US), ("graph", 2110 * US,
                                                  2140 * US)]
        batches.append((2000 * US, 3000 * US))
        generated.append([1, 1])
    return records(host, ops, batches, generated)


def read(name: str, rec: harness.Records):
    return harness.reader(name)(rec)


def test_each_reader_on_a_hand_built_timeline():
    rec = timeline()
    assert read("decode_gap_ms", rec) == pytest.approx((20 + 40) / 2 / 1e3)
    assert read("memory_check_us", rec) == pytest.approx((30 + 50 + 70) / 3)
    assert read("decode_row_use_pct", rec) == pytest.approx(
        100 * 8 / (4 * 3))


def test_spans_outside_the_traced_batches_are_ignored():
    rec = timeline(outside=True)
    # the second batch's one step has no next step: no gap of its own
    assert read("decode_gap_ms", rec) == pytest.approx((20 + 40) / 2 / 1e3)
    assert read("memory_check_us", rec) == pytest.approx(
        (30 + 50 + 70 + 10) / 4)
    assert read("decode_row_use_pct", rec) == pytest.approx(
        100 * (8 + 2) / (4 * 3 + 2 * 1))


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_the_engines_spans_reads_nothing(name):
    rec = timeline()
    rec.trace.host = [h for h in rec.trace.host
                      if not h[0].startswith("repro_torch.serve.")]
    assert read(name, rec) is None
    # nor where one traced batch has none
    rec = timeline(outside=True)
    rec.trace.host = [h for h in rec.trace.host if h[1] < 2000 * US]
    assert read(name, rec) is None


def test_a_traced_small_run_gives_the_span_readers_their_spans():
    """A traced window of a small cell on the CPU: the engine's spans are
    in the reduced trace, one launch a step; no device operation, so no
    gap is read."""
    cell = testing.small_cell("mamba2-2.7b.decode_chat")
    cell.per_layer = list(READERS)
    out = harness.run(cell, 2_200_000_017, 0.2, True, torch.device("cpu"),
                      time.perf_counter())
    got = out.result["metrics"]
    assert "decode_gap_ms" not in got
    assert 0 < got["memory_check_us"]["value"]
    assert 0 < got["decode_row_use_pct"]["value"] <= 100
    assert out.correct
