"""The readings a cell's limit on the logit gap is set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 1]

runs the cell once for each seed on the card, with a short window (by
default one batch), and prints for each run one JSON line: the program's
widest gap (the lower reading's sample) and, on the same rows, the widest
gap of the tokens that the control (the reference with its weights in
8-bit floating point) puts first (the upper reading's).  The limit lies
between the largest of the first over a dozen seeds and the smallest of
the second, which has to be three times it or more.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seeds: list[int], seconds: float = 1.0):
    """(seed, the program's widest gap, the control's, the run's result
    line without its metrics) of each run."""
    import torch

    from portbench import harness

    cell = harness.load_cell(name)
    device = torch.device("cuda", 0)
    for seed in seeds:
        out = harness.run(cell, seed, seconds, False, device,
                          time.perf_counter(), control=True)
        yield seed, out.checks["logit_gap"]["value"], out.control, {
            k: v for k, v in out.result.items() if k != "metrics"}
        del out
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    # run as a script: import from the checkout's root and src/, not from
    # this directory
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path[1:]
        if Path(p or ".").resolve() != ROOT / "portbench"]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    for seed, gap, control, result in readings(
            args.workload, [int(s) for s in args.seeds.split(",")],
            args.seconds):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program_gap": gap, "control_gap": control,
                          **result}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
