"""The port's live multi-tenant flow (launch/multi_tenant.py) against the
reference's examples/multi_tenant.py, on the smoke qwen3-0.6b with the
reference's weights carried across by the bridge: the same tokens, the
same early-restart step; the flow's leases and restart on the CPU; the
full-width growing tenant's traffic checked against the predictor."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.memory.timeseries import \
    PeakMemoryPredictor as RefPeakMemoryPredictor
from repro.core.mig_h100 import MigH100Backend as RefH100
from repro.core.partition_manager import PartitionManager as RefManager
from repro.core.restart import NeedsLargerPartition as RefNeedsLarger
from repro.models import registry as ref_registry
from repro.models.module import cast_tree as ref_cast_tree
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.memory.accountant import MemoryAccountant, pytree_nbytes
from repro_torch.core.memory.timeseries import PeakMemoryPredictor
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.restart import NeedsLargerPartition
from repro_torch.launch import multi_tenant as mt
from repro_torch.models import registry

ARCH = "qwen3-0.6b"
#: the random init's tied embedding dominates its own logits, so greedy
#: decoding from token 0 repeats token 0 in both packages whatever the
#: layers compute; scaled down, the layers pick the tokens
EMBED_SCALE = 0.05
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_mt():
    """examples/multi_tenant.py, loaded with XLA_FLAGS pinned so that its
    setdefault cannot force 16 host devices on this worker's JAX."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        spec = importlib.util.spec_from_file_location(
            "ref_multi_tenant", REPO / "examples" / "multi_tenant.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(ref_mt):
    ref_cfg = ref_get_smoke_config(ARCH)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    ref_p["embedding"] = ref_p["embedding"] * EMBED_SCALE
    cfg = get_smoke_config(ARCH)
    mesh = ref_mt.make_slice_mesh(jax.devices()[:1], (1, 1))
    return ref_cfg, ref_p, mesh, cfg, params_from_numpy(
        jax.device_get(ref_p), cfg)


class Recorder:
    """Wraps either package's predictor: records every observation and the
    step at which will_oom first said yes."""

    def __init__(self, inner):
        self.inner, self.seen, self.flag = inner, [], None

    def observe(self, requested, reuse):
        self.seen.append((requested, reuse))
        return self.inner.observe(requested, reuse)

    def will_oom(self, partition_bytes, pred):
        hit = self.inner.will_oom(partition_bytes, pred)
        if hit and self.flag is None:
            self.flag = (pred.iteration, pred.peak_mem_bytes)
        return hit


@pytest.mark.parametrize("n_tokens,growing", [(24, False), (48, True)])
def test_tokens_match_reference(ref_mt, weights, n_tokens, growing):
    ref_cfg, ref_p, mesh, cfg, p = weights
    want = ref_mt.run_job_on_slice(ref_mt.TenantJob("t", n_tokens, growing),
                                   ref_cfg, ref_p, mesh, partition_gb=10.0)
    got = mt.run_job_on_slice(mt.TenantJob("t", n_tokens, growing), cfg, p,
                              CPU, 10.0)
    assert got == want and len(got) == n_tokens
    assert len(set(got)) > 1


@pytest.mark.parametrize("partition_gb", [0.005, 0.007, 0.008])
def test_early_restart_at_the_reference_step(ref_mt, weights, partition_gb):
    """A small lease: the growing tenant's predictor fires at the same
    decode step on the same byte series; a non-growing tenant runs out."""
    ref_cfg, ref_p, mesh, cfg, p = weights
    ref_pred = Recorder(RefPeakMemoryPredictor(max_iter=48,
                                               converge_tol=0.3))
    pred = Recorder(PeakMemoryPredictor(max_iter=48, converge_tol=0.3))
    with pytest.raises(RefNeedsLarger):
        ref_mt.run_job_on_slice(ref_mt.TenantJob("c", 48, growing=True),
                                ref_cfg, ref_p, mesh, partition_gb, ref_pred)
    with pytest.raises(NeedsLargerPartition):
        mt.run_job_on_slice(mt.TenantJob("c", 48, growing=True), cfg, p,
                            CPU, partition_gb, pred)
    assert pred.seen == ref_pred.seen
    assert pred.flag == ref_pred.flag and pred.flag[0] < 47
    steady = Recorder(PeakMemoryPredictor(max_iter=24, converge_tol=0.3))
    assert len(mt.run_job_on_slice(mt.TenantJob("a", 24), cfg, p, CPU,
                                   partition_gb, steady)) == 24
    assert steady.flag is None and len(steady.seen) == 24


def test_main_smoke_on_cpu_ends_with_the_card_empty(capsys):
    pm = mt.main(["--smoke", "--device", "cpu"])
    assert pm.state == pm.backend.initial_state() and not pm.live
    out = capsys.readouterr().out
    for gpc, reach in ((3, 76), (1, 37), (5, 17)):
        assert f"1g.10gb at GPC {gpc}  (card reachability now {reach})" in out
    assert out.count("done:") == 3 and "back to an empty card: True" in out


def test_flow_restarts_the_flagged_tenant_on_the_next_profile(
        weights, monkeypatch):
    """The growing tenant's predictor run against a small lease (the smoke
    model's series is far below 10 GB): the flow frees its 1g.10gb, leases
    1g.20gb where the reference's manager would, reruns it without a
    predictor and leaves the card empty."""
    _, _, _, cfg, p = weights
    run = mt.run_job_on_slice

    def small_lease(job, cfg, params, device, partition_gb, predictor=None):
        if predictor is not None:
            partition_gb = 0.007
        return run(job, cfg, params, device, partition_gb, predictor)

    monkeypatch.setattr(mt, "run_job_on_slice", small_lease)
    lines = []
    pm, tenants = mt.run_tenants(cfg, p, mt.make_jobs(smoke=True), CPU,
                                 log=lines.append)
    assert pm.state == frozenset() and not pm.live
    assert [t.job.name for t in tenants] == ["tenant-a", "tenant-b",
                                             "tenant-c-growing"]
    assert [(t.reach, [(s.profile, s.gpc) for s in t.slices])
            for t in tenants[:2]] == [(76, [("1g.10gb", 3)]),
                                      (37, [("1g.10gb", 1)])]
    grower = tenants[2]
    first, second = grower.slices
    assert (first.profile, first.gpc, first.flagged.iteration) == (
        "1g.10gb", 5, 33)
    assert first.steps == 34 and second.flagged is None
    assert [len(t.tokens) for t in tenants] == [24, 24, 48]
    assert all(s.peak_gb is None for t in tenants for s in t.slices)
    # the reference's manager through the same leases and releases
    ref = RefH100()
    rpm = RefManager(ref)
    parts = [rpm.allocate(ref.profiles[0]) for _ in range(3)]
    for part in parts:
        rpm.release(part)
    regrown = rpm.allocate(ref.next_larger_profile(ref.profiles[0]))
    assert (second.profile, second.gpc) == (regrown.profile.name,
                                            regrown.handle[0])
    assert any("EARLY RESTART on 1g.20gb" in line for line in lines)


def _series_flag(job, params_b, cache_b, partition_gb):
    acc = MemoryAccountant()
    pred = Recorder(PeakMemoryPredictor(max_iter=job.n_tokens,
                                        converge_tol=0.3))
    for i in range(job.n_tokens):
        live = mt.live_bytes(job, i, params_b, cache_b)
        acc.note_alloc(live * 0.1 + params_b * 0.01)
        acc.note_live(live)
        stats = acc.end_iteration()
        pred.will_oom(partition_gb * 1024 ** 3,
                      pred.observe(stats.requested_bytes, stats.reuse_ratio))
    return pred.flag, max(s.in_use_bytes for s in acc.history)


def test_full_width_growing_tenant_is_flagged_and_fits_the_next_profile():
    """qwen3-0.6b at full width (meta tensors): the growing tenant's series
    is flagged on 1g.10gb before its last step and peaks within 1g.20gb;
    the reference's batch 1 in a context of 256 would never restart."""
    cfg = get_config(ARCH)
    params_b = pytree_nbytes(registry.init_params(None, cfg, "meta")[0])
    assert params_b == 1_192_361_984         # the reference's, in bf16
    backend = MigH100Backend()
    lease = backend.tightest_profile(params_b / 1024 ** 3 * 1.3)
    bigger = backend.next_larger_profile(lease)
    assert (lease.name, bigger.name) == ("1g.10gb", "1g.20gb")
    grower = mt.make_jobs(smoke=False)[-1]
    assert grower == mt.GROWING
    cache_b = pytree_nbytes(registry.init_caches(cfg, grower.batch,
                                                 grower.context, "meta"))
    flag, peak = _series_flag(grower, params_b, cache_b, lease.mem_gb)
    assert flag is not None and flag[0] < grower.n_tokens - 1
    assert flag[1] > lease.mem_gb * 1024 ** 3
    assert lease.mem_gb * 1024 ** 3 < peak <= bigger.mem_gb * 1024 ** 3
    ref_job = mt.TenantJob("c", 48, growing=True)
    ref_cache_b = pytree_nbytes(registry.init_caches(cfg, 1, 256, "meta"))
    flag, peak = _series_flag(ref_job, params_b, ref_cache_b, lease.mem_gb)
    assert flag is None and peak < 2 * 1024 ** 3


def test_memory_lease_is_a_no_op_off_the_card():
    with mt.memory_lease(CPU, 10.0):
        pass
    with pytest.raises(KeyError):
        with mt.memory_lease(CPU, 10.0):
            raise KeyError("passes through")


def test_importing_the_flow_loads_no_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch.launch.multi_tenant, repro_torch.core.planner\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_the_cli_runs_smoke_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multi_tenant", "--smoke",
         "--device", "cpu"], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "batch 1, context 256, 48 tokens" in res.stdout
    assert "back to an empty card: True" in res.stdout


def test_the_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mt.main(["--smoke"])
