"""The port's control plane against the reference, on the CPU: the lease
lifecycle of the reference's own tests (tests/test_control.py) run on both
packages, deferral under an ``AdmissionController``, the ``lease.*``
tracer instants, ledger replay, and the operator CLI
(``python -m repro_torch.control``), whose stdout equals the reference
CLI's for the same arguments and whose ledgers each package replays.

Every comparison is against live ``repro`` in this interpreter, with
``==``.  A status holds each device's FSM state as ``str`` of a frozenset,
whose order follows the interpreter's hash seed: both packages render it
in this one interpreter, and the cross-process check parses it."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import control as ref_control
from repro.control import __main__ as ref_cli
from repro.core.scheduler import admission as ref_admission
from repro.obs import Tracer as RefTracer
from repro_torch import control
from repro_torch.control import __main__ as cli
from repro_torch.core.scheduler import admission
from repro_torch.obs import Tracer

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"port": (control, admission, Tracer, cli),
         "ref": (ref_control, ref_admission, RefTracer, ref_cli)}


def parsed_status(status: dict) -> dict:
    """``status`` with each device's FSM state as its sorted elements
    instead of the frozenset's string, whose order is the hash seed's."""
    status = json.loads(json.dumps(status))
    for dev in status["devices"]:
        text = dev["state"]
        inner = text[len("frozenset("):-1] if text.startswith(
            "frozenset(") else text
        dev["state"] = sorted(ast.literal_eval(inner or "set()"))
    return status


def _outcome(plane, fn):
    """What ``fn(plane)`` returns or raises, then the plane's status."""
    try:
        result = fn(plane)
        if isinstance(result, (control.Lease, ref_control.Lease)):
            result = dataclasses.asdict(result)
        got = ("ok", result)
    except (KeyError, ValueError) as exc:
        got = (type(exc).__name__, str(exc))
    return got, plane.status()


# each case: (plane kwargs, a list of steps); a step is a call on the plane
LIFECYCLE = {
    "provision_busy": ({}, [
        lambda p: p.provision("w", 20.0, compute=0.4, t=0.0),
        lambda p: [part.busy for part in p.devices[0].pm.live.values()]]),
    "duplicate_name": ({}, [
        lambda p: p.provision("w", 5.0),
        lambda p: p.provision("w", 5.0)]),
    "impossible_request": ({}, [
        lambda p: p.provision("huge", 400.0),
        lambda p: len(p.deferred)]),
    "heartbeat_and_expiry": ({"default_lease_s": 30.0}, [
        lambda p: p.provision("w", 5.0, t=0.0),
        lambda p: p.heartbeat("w", t=20.0),
        lambda p: p.tick(t=45.0),
        lambda p: p.tick(t=50.0),
        lambda p: len(p.devices[0].pm.live),
        lambda p: p.heartbeat("w", t=55.0)]),
    "extend_under_load": ({"default_lease_s": 30.0}, [
        lambda p: p.provision("big", 20.0, t=0.0),
        lambda p: p.provision("side", 10.0, t=0.0),
        lambda p: p.provision("slim", 5.0, t=0.0),
        lambda p: p.extend_lease("slim", 100.0, t=10.0),
        lambda p: p.tick(t=31.0),
        lambda p: sorted(p.leases)]),
    "release_retries_deferred": ({}, [
        lambda p: p.provision("a", 20.0),
        lambda p: p.provision("b", 20.0),
        lambda p: p.provision("c", 20.0),
        lambda p: p.release("a"),
        lambda p: sorted(p.leases)]),
    "release_unknown_and_queued": ({}, [
        lambda p: p.release("ghost"),
        lambda p: p.provision("a", 20.0),
        lambda p: p.provision("b", 20.0),
        lambda p: p.provision("c", 20.0),
        lambda p: p.release("c"),
        lambda p: len(p.deferred)]),
    "monotone_clock": ({}, [
        lambda p: p.provision("w", 5.0, t=100.0),
        lambda p: p.heartbeat("w", t=50.0),
        lambda p: p.t]),
    "unknown_op": ({}, [lambda p: p.apply({"op": "destroy"})]),
    "h100_leases": ({"devices": ["h100"]}, [
        lambda p: p.provision("a", 10.0),
        lambda p: p.provision("b", 20.0, compute=0.4),
        lambda p: p.heartbeat("a"),
        lambda p: p.tick(t=70.0),
        lambda p: p.describe()]),
    "mixed_fleet": ({"devices": ["a100", "h100", "a100"]}, [
        lambda p: p.provision("x", 35.0, t=1.0, lease_s=500.0),
        lambda p: p.provision("y", 10.0, compute=0.9, t=2.0),
        lambda p: p.provision("z", 70.0, t=3.0),
        lambda p: p.provision("q", 5.0, t=4.0),
        lambda p: p.release("y", t=9.0),
        lambda p: p.tick(t=64.0),
        lambda p: p.describe()]),
}


@pytest.mark.parametrize("case", list(LIFECYCLE))
def test_lifecycle_equals_the_reference(case):
    kwargs, steps = LIFECYCLE[case]
    got = {}
    for side, (pkg, _, _, _) in SIDES.items():
        kw = dict(kwargs)
        devices = kw.pop("devices", ["a100"])
        plane = pkg.ControlPlane(devices, **kw)
        got[side] = [_outcome(plane, step) for step in steps]
        got[side].append([(d.pm.state, d.pm.n_reconfigs)
                          for d in plane.devices])
    assert got["port"] == got["ref"]


def test_lifecycle_holds_the_reference_tests_assertions():
    """The reference tests' own checks, on the port."""
    plane = control.ControlPlane(["a100"])
    lease = plane.provision("w", 20.0, compute=0.4, t=0.0)
    assert isinstance(lease, control.Lease)
    assert lease.profile in ("3g.20gb", "4g.20gb")
    assert lease.expires_t == control.DEFAULT_LEASE_S
    plane = control.ControlPlane(["a100"], default_lease_s=30.0)
    plane.provision("w", 5.0, t=0.0)
    plane.heartbeat("w", t=20.0)
    assert plane.tick(t=45.0) == [] and plane.tick(t=50.0) == ["w"]
    plane = control.ControlPlane(["a100"])
    for name in "ab":
        plane.provision(name, 20.0)
    assert plane.provision("c", 20.0) is None
    plane.release("a")
    assert "c" in plane.leases
    assert plane.status()["counters"]["deferred"] == 1


def test_admission_gate_defers_as_the_reference():
    """A burst of 20 GB asks under an AdmissionController: the same asks
    are deferred, each ``lease.defer`` instant carries the same reason,
    and a long-quiet release grants the same retries."""
    got = {}
    for side, (pkg, adm, side_tracer, _) in SIDES.items():
        tracer = side_tracer()
        plane = pkg.ControlPlane(
            ["a100"], admission=adm.AdmissionController(horizon_s=30.0),
            tracer=tracer)
        granted = [plane.provision(f"w{i}", 20.0, t=float(i)) is not None
                   for i in range(6)]
        before = len(plane.deferred)
        plane.release("w0", t=500.0)
        got[side] = (granted, before, plane.status(), tracer.records)
    assert got["port"] == got["ref"]
    granted, before, status, records = got["port"]
    assert granted[0] and not all(granted)
    assert len(status["deferred"]) < before and status["leases"]
    assert any(r["name"] == "lease.defer" for r in records)


def test_tracer_sees_lease_events_as_the_reference():
    got = {}
    for side, (pkg, _, side_tracer, _) in SIDES.items():
        tracer = side_tracer()
        plane = pkg.ControlPlane(["a100"], tracer=tracer,
                                 default_lease_s=10.0)
        plane.provision("w", 5.0, t=0.0)
        plane.heartbeat("w", t=5.0)
        plane.extend_lease("w", 3.0, t=6.0)
        plane.tick(t=20.0)
        got[side] = tracer.records
    assert got["port"] == got["ref"]
    assert [r["name"] for r in got["port"] if r.get("cat") == "lease"] == \
        ["lease.grant", "lease.heartbeat", "lease.extend", "lease.expire"]


OPS = [
    {"op": "provision", "name": "a", "mem_gb": 20.0, "t": 0.0},
    {"op": "provision", "name": "b", "mem_gb": 10.0, "t": 5.0,
     "lease_s": 120.0},
    {"op": "heartbeat", "name": "a", "t": 30.0},
    {"op": "extend_lease", "name": "b", "extra_s": 60.0, "t": 40.0},
    {"op": "tick", "t": 95.0},
    {"op": "release", "name": "b", "t": 100.0},
    {"op": "provision", "name": "c", "mem_gb": 5.0, "t": 110.0},
]


@pytest.mark.parametrize("devices", [["a100", "a100"], ["h100", "a100"]])
def test_replay_equals_live_and_the_reference(devices):
    live = control.ControlPlane(devices)
    for op in OPS:
        live.apply(op)
    replayed = control.ControlPlane(devices)
    replayed.replay(OPS)
    ref = ref_control.ControlPlane(devices)
    ref.replay(OPS)
    assert replayed.status() == live.status() == ref.status()
    for d1, d2, d3 in zip(live.devices, replayed.devices, ref.devices):
        assert d1.pm.state == d2.pm.state == d3.pm.state
        assert d1.pm.n_reconfigs == d2.pm.n_reconfigs == d3.pm.n_reconfigs


# -- the CLI -----------------------------------------------------------------------

#: argument lists run in order on one ledger: provision on a fresh ledger,
#: the status table and JSON, heartbeat, extension, a failed op, tick,
#: release and the H100 leases of chip_smoke's phase 9
CLI_SCRIPTS = {
    "a100_round_trip": [
        ["--devices", "a100,a100", "provision", "--name", "train",
         "--mem-gb", "20", "--lease-s", "120"],
        ["status"], ["status", "--json"],
        ["provision", "--name", "w", "--mem-gb", "5", "--compute", "0.3"],
        ["heartbeat", "--name", "w", "--t", "50"],
        ["extend-lease", "--name", "train", "--extra-s", "30", "--t", "60"],
        ["release", "--name", "ghost"],
        ["tick", "--t", "100"], ["tick", "--t", "111"],
        ["release", "--name", "train"], ["status", "--json"]],
    "h100_phase9": [
        ["--devices", "h100", "provision", "--name", "a", "--mem-gb", "10"],
        ["provision", "--name", "b", "--mem-gb", "20", "--compute", "0.4"],
        ["status", "--json"], ["heartbeat", "--name", "a"],
        ["tick", "--t", "70"], ["status", "--json"], ["status"]],
    "deferred": [
        ["--devices", "a100", "provision", "--name", "a", "--mem-gb", "20"],
        ["provision", "--name", "b", "--mem-gb", "20"],
        ["provision", "--name", "c", "--mem-gb", "20"],
        ["status"], ["release", "--name", "a", "--t", "5"],
        ["status", "--json"]],
}


def _run_cli(main, path, argv, capsys):
    rc = main(["--state", str(path), *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("script", list(CLI_SCRIPTS))
def test_cli_stdout_and_ledger_equal_the_reference(script, tmp_path, capsys):
    got = {}
    for side, (_, _, _, side_cli) in SIDES.items():
        path = tmp_path / f"{side}.json"
        got[side] = ([_run_cli(side_cli.main, path, argv, capsys)
                      for argv in CLI_SCRIPTS[script]],
                     json.loads(path.read_text()))
    assert got["port"] == got["ref"]
    assert cli.LEDGER_VERSION == ref_cli.LEDGER_VERSION == 1
    if script == "h100_phase9":
        outs = [out for _, out, _ in got["port"][0]]
        leases = json.loads(outs[2])["leases"]
        assert [l["profile"] for l in leases] == ["1g.10gb", "3g.40gb"]
        after = json.loads(outs[5])
        assert after["counters"]["expired"] == 2
        assert parsed_status(after)["devices"][0]["state"] == []


def test_cli_refuses_a_reshaped_ledger_as_the_reference(tmp_path, capsys):
    for side, (_, _, _, side_cli) in SIDES.items():
        path = tmp_path / f"{side}.json"
        _run_cli(side_cli.main, path, ["--devices", "a100", "provision",
                                       "--name", "w", "--mem-gb", "5"],
                 capsys)
        with pytest.raises(SystemExit):
            side_cli.main(["--state", str(path), "--devices", "h100",
                           "status"])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_replays_the_others_ledger(writer, tmp_path, capsys):
    """A ledger the ``writer``'s CLI wrote rebuilds, through the other
    package's ``build_plane``, to the writer's own status."""
    path = tmp_path / "plane.json"
    side_cli = SIDES[writer][3]
    for argv in CLI_SCRIPTS["a100_round_trip"] + [
            ["provision", "--name", "late", "--mem-gb", "35", "--t", "200"]]:
        _run_cli(side_cli.main, path, argv, capsys)
    ledger = json.loads(path.read_text())
    reader = ref_cli if writer == "port" else cli
    assert reader.build_plane(ledger).status() == \
        side_cli.build_plane(ledger).status()
    assert reader.load_ledger(path, None) == ledger


def test_python_m_entry_prints_the_status(tmp_path, capsys):
    """``python -m repro_torch.control`` in its own process reads the
    ledger the in-process CLI wrote; the state is compared parsed, as the
    subprocess has its own hash seed."""
    path = tmp_path / "plane.json"
    for argv in CLI_SCRIPTS["h100_phase9"][:2]:
        assert _run_cli(cli.main, path, argv, capsys)[0] == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.control", "--state", str(path),
         "status", "--json"], capture_output=True, text=True, env=env,
        check=True)
    live = cli.build_plane(json.loads(path.read_text()))
    assert parsed_status(json.loads(proc.stdout)) == \
        parsed_status(live.status())
