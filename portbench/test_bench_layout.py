"""A later configuration, cell, mix or metric is new files and new
entries: the harness finds each by its name, with no file that is there
edited."""

from __future__ import annotations

import hashlib
import json
import shutil

from portbench import harness
from portbench.harness import ROOT


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "portbench")

    here = tmp_path / "portbench"
    (here / "mixes" / "mixed.json").write_text(json.dumps(
        {"prompt_tokens": {"low": 64, "high": 4096},
         "new_tokens": {"low": 16, "high": 256}}))
    (here / "cells" / "mamba2-2.7b.mixed.json").write_text(json.dumps(
        {"batch": 16, "mig_profile": "3g.40gb",
         "check": {"tokens": 256, "rows": 4, "limit": 1.0}}))
    (here / "metrics" / "padding_share.py").write_text(
        "def read(rec):\n    return 42.0\n")
    # a configuration of another family, with its own model module
    config = json.loads((here / "configs" / "mamba2-2.7b.json").read_text())
    config.update(name="dense-1b", reference="dense")
    (here / "configs" / "dense-1b.json").write_text(json.dumps(config))
    (here / "cells" / "dense-1b.decode_chat.json").write_text(json.dumps(
        {"batch": 8, "mig_profile": "1g.10gb",
         "check": {"tokens": 256, "rows": 4, "limit": 1.0}}))
    (here / "reference" / "dense.py").write_text(
        "def request_flops(m, prompt, generated):\n    return 7\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dense-1b",
                                 file="portbench/configs/dense-1b.json"))
    bench["workloads"].append({"name": "mamba2-2.7b.mixed",
                               "config": "mamba2-2.7b", "traffic": "mixed",
                               "chips": 1, "why": "both regimes in one queue"})
    bench["workloads"].append({"name": "dense-1b.decode_chat",
                               "config": "dense-1b", "traffic": "decode_chat",
                               "chips": 1, "why": "another family"})
    bench["per_layer"].append({"name": "padding_share", "unit": "%",
                               "better": "lower", "source": "program_counter",
                               "layer": "engine prefill",
                               "moves": "output_tokens_per_s",
                               "workloads": ["mamba2-2.7b.mixed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("mamba2-2.7b.mixed", root=tmp_path)
    assert cell.mix["prompt_tokens"]["high"] == 4096
    assert cell.cell["mig_profile"] == "3g.40gb"
    assert cell.config["model"]["name"] == "mamba2-2.7b"
    assert "padding_share" in cell.per_layer
    assert cell.reference.request_flops(cell.config["model"], 1, 0) > 0
    assert harness.reader("padding_share", root=tmp_path)(None) == 42.0
    other = harness.load_cell("dense-1b.decode_chat", root=tmp_path)
    assert other.reference.request_flops(None, 1, 1) == 7
    assert "padding_share" not in other.per_layer
    after = digests(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_finds_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for wl in bench["workloads"]:
        cell = harness.load_cell(wl["name"])
        assert cell.end_to_end and cell.per_layer
        for name in cell.per_layer:
            assert callable(harness.reader(name))
