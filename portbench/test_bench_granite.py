"""The readers of the granite-4.0-h-small cell's per-layer metrics
(``flash_attention_roofline``, ``moe_prefill_ms_per_ktok``) on hand-built
timelines, and without what they read."""

from __future__ import annotations

import pytest

from portbench import devtrace, harness

CELL = "granite-4.0-h-small.decode_chat"

MS = 1_000_000   # ns
MODEL = {"n_layers": 20, "attn_layers": [5, 15], "n_heads": 32,
         "n_kv_heads": 8, "head_dim": 128}


def records(ops, host, batches, prompts, padded) -> harness.Records:
    cell = harness.load_cell(CELL)
    trace = devtrace.Trace(sorted(ops, key=lambda o: o[1]), [], batches,
                           host)
    return harness.Records(
        trace, [harness.Batch(p, [1] * len(p), padded, len(p))
                for p in prompts], dict(cell.config["model"], **MODEL),
        cell.reference)


def read(name, rec):
    return harness.reader(name)(rec)


def test_the_flash_roofline_is_the_least_time_over_the_launches():
    """Two attention layers a batch, each launch 2 ms, at B=2 and a padded
    prompt of 512: the bound is work.attention_work's at that shape."""
    from portbench import work
    ops = [("flash_fwd_sm90_kernel<128, 2>", 10 * MS, 12 * MS),
           ("ssd_scan_sm90_kernel", 12 * MS, 13 * MS),
           ("flash_fwd_sm90_kernel<128, 2>", 20 * MS, 22 * MS)]
    rec = records(ops, [], [(0, 100 * MS)], [[300, 512]], 512)
    nbytes, flops = work.attention_work(2, 32, 8, 512, 128, 2, True, None)
    assert read("flash_attention_roofline", rec) == pytest.approx(
        100 * 2 * work.bound_s(flops, nbytes) / 4e-3)
    # a launch missing: nothing is read
    rec.trace.ops = rec.trace.ops[:2]
    assert read("flash_attention_roofline", rec) is None


def test_the_moe_prefill_spans_per_thousand_prompt_tokens():
    host = [("repro_torch.serve.moe", 10 * MS, 13 * MS),
            ("repro_torch.serve.moe", 20 * MS, 21 * MS),
            ("repro_torch.serve.moe", 150 * MS, 160 * MS)]   # outside
    rec = records([], host, [(0, 100 * MS)], [[300, 500]], 500)
    assert read("moe_prefill_ms_per_ktok", rec) == pytest.approx(4 / 0.8)
    rec.trace.host = []
    assert read("moe_prefill_ms_per_ktok", rec) is None
