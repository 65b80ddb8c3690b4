"""The port's partition layer against the reference, on both MIG cards the
paper uses: the span FSMs, Algorithm 2's reachability, the compiled
transition graph and Algorithm 3's partition manager (allocation, fusion /
fission, release), decision for decision."""

import numpy as np
import pytest

from repro.core import reachability as ref_reach
from repro.core.mig_a100 import MigA100Backend as RefA100
from repro.core.mig_h100 import MigH100Backend as RefH100
from repro.core.partition_manager import PartitionManager as RefManager
from repro.core.partition_state import enumerate_states as ref_states
from repro.core.partition_state import saturated as ref_saturated
from repro.core.planner.graph import compile_transition_graph as ref_compile
from repro_torch.core import reachability
from repro_torch.core.mig_a100 import MigA100Backend
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.mig_span import MigSpanBackend
from repro_torch.core.partition_manager import PartitionManager
from repro_torch.core.partition_state import enumerate_states, saturated
from repro_torch.core.planner import cost, graph
from repro_torch.core.planner.graph import compile_transition_graph

CARDS = {"a100": (MigA100Backend, RefA100), "h100": (MigH100Backend, RefH100)}


@pytest.fixture(params=sorted(CARDS), scope="module")
def card(request):
    port_cls, ref_cls = CARDS[request.param]
    return request.param, port_cls(), ref_cls()


def _placement(pl):
    return None if pl is None else (pl.profile.name, pl.handle, pl.next_state)


def test_profile_tables_match(card):
    _, port, ref = card
    assert [(p.name, p.mem_gb, p.compute_fraction, p.extent)
            for p in port.profiles] == [
        (p.name, p.mem_gb, p.compute_fraction, p.extent)
        for p in ref.profiles]
    assert port.reachability_cache_key() == ref.reachability_cache_key()


def test_reachability_and_saturation_of_every_state(card):
    _, port, ref = card
    states = enumerate_states(port)
    assert states == ref_states(ref)
    fcr = reachability.precompute_reachability(port)
    assert fcr == ref_reach.precompute_reachability(ref)
    for s in states:
        assert saturated(port, s) == ref_saturated(ref, s)
        assert port.reachability(s) == ref.reachability(s)


def test_fully_configured_states(card):
    name, port, ref = card
    full = reachability.fully_configured_states(port)
    assert sorted(map(sorted, full)) == sorted(
        map(sorted, ref_reach.fully_configured_states(ref)))
    assert len(full) == {"a100": 19, "h100": 148}[name]
    assert port.reachability(port.initial_state()) == len(full)
    assert all(port.reachability(s) == 1 for s in full)


def test_compiled_graph_matches_for_every_state_and_profile(card):
    _, port, ref = card
    g, rg = compile_transition_graph(port), ref_compile(ref)
    assert (g.n_states, g.n_transitions) == (rg.n_states, rg.n_transitions)
    assert set(g.states) == set(rg.states)
    for s in g.states:
        assert g.reach(s) == rg.reach(s)
        for prof, rprof in zip(port.profiles, ref.profiles):
            assert [_placement(p) for p in g.placements(s, prof)] == [
                _placement(p) for p in rg.placements(s, rprof)]
            assert _placement(g.best_placement(s, prof)) == _placement(
                rg.best_placement(s, rprof))


def test_graph_is_shared_per_device_table(card):
    _, port, _ = card
    assert compile_transition_graph(port) is compile_transition_graph(
        type(port)())


def test_clear_empties_every_registered_cache():
    backend = MigH100Backend()
    compile_transition_graph(backend)
    cost.normalized_reachability(backend, backend.initial_state())
    key = backend.reachability_cache_key()
    assert key in reachability._CACHE and key in graph._GRAPH_CACHE
    assert key in cost._REACH0_LOG
    reachability.clear_reachability_cache()
    assert not reachability._CACHE and not graph._GRAPH_CACHE
    assert not cost._REACH0_LOG
    assert compile_transition_graph(backend).n_states == 1076


def test_caches_are_bounded():
    reachability.clear_reachability_cache()
    for n in range(reachability.MAX_CACHED_BACKENDS + 3):
        compile_transition_graph(MigSpanBackend(
            f"tiny{n}", {"1g": (1, 1, (0,))}, n_gpc=1, n_mem_slices=1,
            mem_slice_gb=1.0 + n))
    assert len(reachability._CACHE) == reachability.MAX_CACHED_BACKENDS
    assert len(graph._GRAPH_CACHE) == reachability.MAX_CACHED_BACKENDS
    reachability.clear_reachability_cache()


def _snapshot(pm):
    return (pm.state, pm.n_reconfigs, pm.describe(),
            {pid: (p.profile.name, p.handle, p.busy)
             for pid, p in pm.live.items()})


@pytest.mark.parametrize("compiled", [True, False], ids=["graph", "online"])
@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences_match(card, seed, compiled):
    """allocate / allocate_with_reshape / release / busy marks, seeded: the
    same handles, states, n_reconfigs and describe() after every op."""
    _, port, ref = card
    pm = PartitionManager(port, use_compiled_graph=compiled)
    rpm = RefManager(ref, use_compiled_graph=compiled)
    rng = np.random.default_rng(seed)
    n_prof = len(port.profiles)
    for _ in range(150):
        op, k = int(rng.integers(4)), int(rng.integers(1 << 30))
        if op < 2:
            fn = "allocate" if op == 0 else "allocate_with_reshape"
            got = getattr(pm, fn)(port.profiles[k % n_prof])
            want = getattr(rpm, fn)(ref.profiles[k % n_prof])
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.pid, got.handle) == (want.pid, want.handle)
        elif pm.live:
            pid = sorted(pm.live)[k % len(pm.live)]
            if op == 2:
                pm.release(pm.live[pid])
                rpm.release(rpm.live[pid])
            else:
                pm.live[pid].busy = rpm.live[pid].busy = (
                    not pm.live[pid].busy)
        assert _snapshot(pm) == _snapshot(rpm)
        assert pm.reach(pm.state) == rpm.reach(rpm.state)
        assert [p.pid for p in pm.idle_partitions()] == [
            p.pid for p in rpm.idle_partitions()]


def test_failed_reshape_is_an_exact_no_op(card):
    """Busy partitions block the wanted profile: the reshape fails on both
    managers and leaves the port's bit-for-bit as it was (same state, same
    Partition objects, same counters, the next pid unchanged)."""
    _, port, ref = card
    pm, rpm = PartitionManager(port), RefManager(ref)
    small, rsmall = port.profiles[0], ref.profiles[0]
    for i in range(4):
        busy = i % 2 == 0
        pm.allocate(small).busy = busy
        rpm.allocate(rsmall).busy = busy
    before = _snapshot(pm)
    objects = dict(pm.live)
    assert pm.allocate_with_reshape(port.profiles[-1]) is None
    assert rpm.allocate_with_reshape(ref.profiles[-1]) is None
    assert _snapshot(pm) == before == _snapshot(rpm)
    assert all(pm.live[k] is v for k, v in objects.items())
    assert pm.allocate(small).pid == rpm.allocate(rsmall).pid == 4


def test_reshape_consumes_idle_partitions(card):
    _, port, ref = card
    pm, rpm = PartitionManager(port), RefManager(ref)
    for _ in range(7):
        pm.allocate(port.profiles[0])
        rpm.allocate(ref.profiles[0])
    big = next(i for i, p in enumerate(port.profiles) if p.extent >= 3)
    assert pm.allocate(port.profiles[big]) is None
    got = pm.allocate_with_reshape(port.profiles[big])
    want = rpm.allocate_with_reshape(ref.profiles[big])
    assert (got.pid, got.handle) == (want.pid, want.handle)
    assert _snapshot(pm) == _snapshot(rpm)
    assert list(pm.live) == [got.pid] and pm.n_reconfigs == 7 + 1 + 7


def test_idle_partition_with_and_best_placement_on_hypothetical_states(card):
    _, port, ref = card
    pm, rpm = PartitionManager(port), RefManager(ref)
    for prof, rprof in zip(port.profiles[:3], ref.profiles[:3]):
        pm.allocate(prof)
        rpm.allocate(rprof)
    pm.live[1].busy = rpm.live[1].busy = True
    for prof, rprof in zip(port.profiles, ref.profiles):
        got, want = pm.idle_partition_with(prof), rpm.idle_partition_with(
            rprof)
        assert (got and got.pid) == (want and want.pid)
        for s in enumerate_states(port):
            assert _placement(pm.best_placement(s, prof)) == _placement(
                rpm.best_placement(s, rprof))


def test_h100_leases_of_full_width_qwen3():
    """Three tight leases of 1.3x qwen3-0.6b's 1.110 GiB of bf16 weights:
    1g.10gb at GPC 3, 1 and 5, reachability 148 -> 76 -> 37 -> 17, and
    Hopper's 1g.20gb is the next larger profile."""
    backend = MigH100Backend()
    pm = PartitionManager(backend)
    profile = backend.tightest_profile(596_049_920 * 2 / 2 ** 30 * 1.3)
    assert profile.name == "1g.10gb"
    assert pm.reach(pm.state) == 148
    got = []
    for _ in range(3):
        part = pm.allocate(profile)
        got.append((part.handle[0], pm.reach(pm.state)))
    assert got == [(3, 76), (1, 37), (5, 17)]
    assert backend.next_larger_profile(profile).name == "1g.20gb"
