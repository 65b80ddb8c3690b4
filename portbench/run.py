"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It needs as many CUDA cards as the cell asks
for, and exits with another code than 0, printing no result, without
them, or where the program under ``src/`` is missing.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error give the same checks.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's package lives under src/; this directory itself is no
# place to import from (its module names are the benchmark's own)
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path[1:] if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench import guard  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import energy, harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; a run needs "
              "the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    counter = energy.EnergyCounter(energy.card_uuid(device))
    try:
        outcome = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                              device, STARTED, counter)
    finally:
        counter.close()
    found = guard.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: modules of the JAX side were loaded: {found}",
              file=sys.stderr)
        return 3
    line = {"correct": outcome.correct, **outcome.result,
            "checks": outcome.checks}
    for name, c in outcome.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
