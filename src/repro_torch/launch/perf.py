"""Sharding hillclimbing CLI — hypothesis -> change -> re-trace ->
measure.

Each experiment is (arch, shape, mesh, policy, microbatches); results
append to experiments/perf/<name>.json and print the roofline row.

    PYTHONPATH=src python -m repro_torch.launch.perf --name qwen3_train \\
        --arch qwen3-0.6b --shape train_4k --policy no_fsdp

The port's copy of the reference's ``repro/launch/perf.py`` over the
meta-device dry run (:mod:`repro_torch.launch.dryrun`): host code, no
card.  The reference's ``--keep-hlo`` has no counterpart (the port makes
no HLO).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.launch.analysis import ROOFLINE_HEADER
from repro_torch.launch.dryrun import collectives_line, roofline_of, run_combo
from repro_torch.sharding.partitioning import POLICIES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--name", required=True)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default="baseline", choices=list(POLICIES))
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--windowed-cache", action="store_true")
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)

    overrides = {"windowed_cache": True} if args.windowed_cache else None
    res = run_combo(args.arch, args.shape, args.multi_pod,
                    policy=args.policy, microbatches=args.microbatches,
                    config_overrides=overrides)
    print(ROOFLINE_HEADER)
    if res.ok:
        print(roofline_of(res).row()
              + f"  [{res.per_device_bytes / 2**30:.2f} GiB/dev, "
              f"{res.compile_s:.1f}s trace]")
        print(collectives_line(res.collectives))
    else:
        print(f"FAILED: {res.error[:500]}")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.name}.json")
    hist = []
    if os.path.exists(path):
        with open(path) as f:
            hist = json.load(f)
    entry = dataclasses.asdict(res)
    entry["microbatches"] = args.microbatches
    hist.append(entry)
    with open(path, "w") as f:
        json.dump(hist, f, indent=1)
    print(f"appended -> {path} ({len(hist)} runs)")
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
