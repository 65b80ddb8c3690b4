"""``python -m repro_torch.control`` — the operator CLI over
:class:`ControlPlane`; the port's copy of ``python -m repro.control``.

State is a JSON *operation ledger*: the file records the device shape
plus every applied operation, and each invocation rebuilds the plane by
replaying the ledger (every verb is deterministic in state + operation),
applies the new operation, and appends it.  No pickles, no hidden
state — ``cat plane.json`` is the full history.  The ledger's layout is
the reference's, so either package replays a ledger the other wrote.

Examples::

    python -m repro_torch.control --state plane.json --devices a100,a100 \\
        provision --name train-7b --mem-gb 20 --compute 0.4 --lease-s 120
    python -m repro_torch.control --state plane.json status
    python -m repro_torch.control --state plane.json heartbeat --name train-7b --t 60
    python -m repro_torch.control --state plane.json tick --t 300
    python -m repro_torch.control --state plane.json release --name train-7b
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from repro_torch.control.plane import DEFAULT_LEASE_S, ControlPlane, Lease

#: bumped when the ledger layout changes incompatibly.
LEDGER_VERSION = 1


def load_ledger(path: Path, devices: list[str] | None) -> dict:
    """Read the ledger at ``path``; a missing file starts a fresh one
    with ``devices`` (default one a100)."""
    if path.exists():
        ledger = json.loads(path.read_text())
        if ledger.get("version") != LEDGER_VERSION:
            raise SystemExit(f"{path}: unsupported ledger version "
                             f"{ledger.get('version')!r}")
        if devices and devices != ledger["devices"]:
            raise SystemExit(
                f"{path} was created with --devices "
                f"{','.join(ledger['devices'])}; it cannot be reshaped")
        return ledger
    return {"version": LEDGER_VERSION,
            "devices": devices or ["a100"], "ops": []}


def build_plane(ledger: dict) -> ControlPlane:
    """A plane rebuilt by replaying the ledger's operation list."""
    plane = ControlPlane(ledger["devices"])
    plane.replay(ledger["ops"])
    return plane


def _render(result) -> str:
    if isinstance(result, Lease):
        return json.dumps(dataclasses.asdict(result), indent=2)
    return json.dumps(result, indent=2)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.control",
        description="Lease-based MIG provisioning over a JSON op ledger.")
    parser.add_argument("--state", default="plane.json",
                        help="ledger path (default: ./plane.json)")
    parser.add_argument("--devices", default=None,
                        help="comma-separated catalogue models for a NEW "
                             "ledger, e.g. a100,a100,h100")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("provision", help="carve a slice and grant a lease")
    p.add_argument("--name", required=True)
    p.add_argument("--mem-gb", type=float, required=True)
    p.add_argument("--compute", type=float, default=0.0)
    p.add_argument("--lease-s", type=float, default=DEFAULT_LEASE_S)
    p.add_argument("--t", type=float, default=None)

    for cmd, hlp in (("heartbeat", "renew a lease's liveness window"),
                     ("release", "free a lease's slice")):
        p = sub.add_parser(cmd, help=hlp)
        p.add_argument("--name", required=True)
        p.add_argument("--t", type=float, default=None)

    p = sub.add_parser("extend-lease", help="push a lease's expiry out")
    p.add_argument("--name", required=True)
    p.add_argument("--extra-s", type=float, required=True)
    p.add_argument("--t", type=float, default=None)

    p = sub.add_parser("tick", help="advance the clock; reclaim lapsed leases")
    p.add_argument("--t", type=float, required=True)

    p = sub.add_parser("status", help="print the plane snapshot")
    p.add_argument("--json", action="store_true",
                   help="machine-readable snapshot instead of the table")

    args = parser.parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    path = Path(args.state)
    ledger = load_ledger(path, devices)
    plane = build_plane(ledger)

    if args.cmd == "status":
        print(json.dumps(plane.status(), indent=2) if args.json
              else plane.describe())
        if not path.exists():   # `status` on a fresh ledger still creates it
            path.write_text(json.dumps(ledger, indent=2) + "\n")
        return 0

    op = {"op": args.cmd.replace("-", "_")}
    for key in ("name", "mem_gb", "compute", "lease_s", "extra_s", "t"):
        if hasattr(args, key) and getattr(args, key) is not None:
            op[key] = getattr(args, key)
    try:
        result = plane.apply(op)
    except (KeyError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    # only successfully-applied ops enter the ledger, so replay never raises
    ledger["ops"].append(op)
    path.write_text(json.dumps(ledger, indent=2) + "\n")
    if result is None:
        print(f"deferred: {op.get('name', '?')} queued "
              f"(admission floor or no capacity)")
    else:
        print(_render(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
