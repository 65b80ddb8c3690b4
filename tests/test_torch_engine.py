"""The port's serving engine, restart policy and predictor against the
reference's (tests/test_training_serving.py:120-176 mirrored), on bridged
f32 smoke weights on the CPU; and the port's independence from JAX."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.memory.timeseries import \
    PeakMemoryPredictor as RefPeakMemoryPredictor
from repro.core.mig_h100 import MigH100Backend as RefMigH100Backend
from repro.core.restart import NeedsLargerPartition as RefNeedsLargerPartition
from repro.models import registry as ref_registry
from repro.models.module import cast_tree as ref_cast_tree
from repro.serving import engine as ref_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.memory.timeseries import PeakMemoryPredictor
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.restart import NeedsLargerPartition
from repro_torch.launch.serve import make_requests, serve
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

ARCH = "qwen3-0.6b"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_get_smoke_config(ARCH)
    ref_p, _ = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_p = ref_cast_tree(ref_p, jnp.float32)
    cfg = get_smoke_config(ARCH)
    return ref_cfg, ref_p, cfg, params_from_numpy(jax.device_get(ref_p), cfg)


def _prompts(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 10))).astype(np.int32)
            for _ in range(n)]


def _pair_requests(prompts, max_new):
    return ([ref_engine.Request(uid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)],
            [Request(uid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)])


def _series_close(a, b):
    for xs, ys in zip(a.series(), b.series()):
        assert len(xs) == len(ys)
        np.testing.assert_allclose(xs, ys, rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_tokens_and_series_match_reference(weights, impl):
    ref_cfg, ref_p, cfg, p = weights
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    ref_reqs, reqs = _pair_requests(_prompts(3, 3, cfg.vocab), 10)
    ecfg = dict(max_batch=3, max_context=64, predict=False)
    ref_out = ref_engine.ServeEngine(
        ref_cfg, ref_p, ref_engine.EngineConfig(**ecfg)).run(ref_reqs)
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg), device="cpu")
    out = eng.run(reqs)
    assert [r.generated for r in out] == [r.generated for r in ref_out]
    assert all(len(r.generated) == 10 for r in out)
    ref_eng_series = ref_engine.ServeEngine(
        ref_cfg, ref_p, ref_engine.EngineConfig(**ecfg))
    ref_eng_series.run(_pair_requests(_prompts(3, 3, cfg.vocab), 10)[0])
    _series_close(eng.accountant, ref_eng_series.accountant)
    _, reuse = eng.accountant.series()
    assert all(0 < r <= 1 for r in reuse)


def test_engine_reuse_resets_per_run_state(weights):
    _, _, cfg, p = weights

    def reqs():
        return [Request(uid=i, prompt=np.arange(4, dtype=np.int32),
                        max_new_tokens=8) for i in range(2)]
    eng = ServeEngine(cfg, p, EngineConfig(max_batch=2, max_context=64,
                                           predict=False), device="cpu")
    eng.run(reqs())
    first = [s.requested_bytes for s in eng.accountant.history]
    eng.run(reqs())
    second = [s.requested_bytes for s in eng.accountant.history]
    assert len(second) == len(first)
    assert second == pytest.approx(first, rel=1e-6)

    pred_eng = ServeEngine(cfg, p, EngineConfig(max_batch=2, max_context=64,
                                                partition_gb=1e3,
                                                predict=True), device="cpu")
    pred_eng.run(reqs())
    n_obs = len(pred_eng.predictor.req_mem_list)
    pred_eng.run(reqs())
    assert len(pred_eng.predictor.req_mem_list) == n_obs


def test_early_restart_same_step_and_profile(weights):
    ref_cfg, ref_p, cfg, p = weights
    ecfg = dict(max_batch=1, max_context=96, partition_gb=1e-4, predict=True)
    prompt = np.arange(4, dtype=np.int32)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_p,
                                     ref_engine.EngineConfig(**ecfg),
                                     backend=RefMigH100Backend())
    with pytest.raises(RefNeedsLargerPartition) as ref_exc:
        ref_eng.run([ref_engine.Request(uid=0, prompt=prompt,
                                        max_new_tokens=80)])
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg),
                      backend=MigH100Backend(), device="cpu")
    with pytest.raises(NeedsLargerPartition) as exc:
        eng.run([Request(uid=0, prompt=prompt, max_new_tokens=80)])
    assert exc.value.profile.name == ref_exc.value.profile.name == "1g.10gb"
    assert exc.value.profile.mem_gb == ref_exc.value.profile.mem_gb
    assert len(eng.accountant.history) == len(ref_eng.accountant.history)
    assert (eng.predictor.req_mem_list
            == pytest.approx(ref_eng.predictor.req_mem_list, rel=1e-6))


def test_serve_loop_regrows_and_finishes(weights):
    _, _, cfg, p = weights
    reqs = make_requests(cfg, 2, 6, 12, seed=0)
    lines = []
    engine, out, restarts = serve(cfg, p, reqs, max_context=64,
                                  partition_gb=1e-4,
                                  backend=MigH100Backend(), device="cpu",
                                  log=lines.append)
    assert restarts == lines and len(restarts) == 1
    assert "1g.10gb" in restarts[0]
    assert engine.ecfg.partition_gb == 10.0
    assert all(len(r.generated) == 12 for r in out)


def test_peak_predictor_copy_matches_reference():
    rng = np.random.default_rng(0)
    req = np.cumsum(1e6 + rng.random(40) * 2e5)
    reuse = 0.9 / (1 + 0.05 * np.arange(40)) + rng.random(40) * 0.01
    ref = RefPeakMemoryPredictor(max_iter=200)
    port = PeakMemoryPredictor(max_iter=200)
    for m, r in zip(req, reuse):
        a, b = ref.observe(m, r), port.observe(m, r)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for part in (1e7, 5e7):
            assert ref.will_oom(part, a) == port.will_oom(part, b)
            assert ref.oom_risk(part, a) == port.oom_risk(part, b)


def test_mig_h100_copy_matches_reference():
    """Profiles, placements and Algorithm 2 reachability of the port's
    H100 MIG FSM equal the reference's on every reachable state."""
    from repro.core.partition_state import enumerate_states as ref_states
    from repro.core.reachability import precompute_reachability as ref_fcr
    from repro_torch.core.reachability import precompute_reachability
    ref, port = RefMigH100Backend(), MigH100Backend()
    assert ([dataclasses.astuple(p) for p in port.profiles]
            == [dataclasses.astuple(p) for p in ref.profiles])
    fcr, want = precompute_reachability(port), ref_fcr(ref)
    assert fcr == want and len(fcr) == len(ref_states(ref)) > 100
    for state in list(want)[:200]:
        for rp, pp in zip(ref.profiles, port.profiles):
            assert ([pl.next_state for pl in
                     port.enumerate_placements(state, pp)]
                    == [pl.next_state for pl in
                        ref.enumerate_placements(state, rp)])


@pytest.mark.parametrize("mem_gb,headroom", [(0.5, 1.0), (10.0, 1.0),
                                             (15.0, 1.0), (9.5, 1.2),
                                             (35.0, 1.0), (75.0, 1.2)])
def test_restart_targets_match_reference(mem_gb, headroom):
    from repro.core.restart import early_restart_target as ref_early
    from repro.core.restart import oom_restart_target as ref_oom
    from repro_torch.core.restart import (early_restart_target,
                                          oom_restart_target)
    ref, port = RefMigH100Backend(), MigH100Backend()
    got = early_restart_target(port, mem_gb, headroom)
    want = ref_early(ref, mem_gb, headroom)
    assert (got and got.name) == (want and want.name)
    for rp, pp in zip(ref.profiles, port.profiles):
        assert oom_restart_target(port, pp).name == ref_oom(ref, rp).name


def test_with_oom_retry_turns_cuda_oom_into_restart():
    import torch
    from repro_torch.core.restart import with_oom_retry
    port = MigH100Backend()
    g10 = port.profiles[0]

    def boom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    assert with_oom_retry(lambda x: x + 1, backend=port, profile=g10)(41) == 42
    with pytest.raises(NeedsLargerPartition) as exc:
        with_oom_retry(boom, backend=port, profile=g10)()
    assert exc.value.profile.mem_gb == 20.0
    with pytest.raises(ValueError):   # other errors pass through
        with_oom_retry(lambda: int("x"), backend=port, profile=g10)()


@pytest.mark.parametrize("max_retries", [0, 4, 9])
def test_with_oom_retry_takes_the_reference_max_retries(max_retries):
    import inspect

    import torch
    from repro.core.restart import with_oom_retry as ref_retry
    from repro_torch.core.restart import with_oom_retry
    assert list(inspect.signature(with_oom_retry).parameters) == list(
        inspect.signature(ref_retry).parameters)
    port, g10 = MigH100Backend(), MigH100Backend().profiles[0]

    def boom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    step = with_oom_retry(lambda x: x + 1, backend=port, profile=g10,
                          max_retries=max_retries)
    assert step(41) == 42
    with pytest.raises(NeedsLargerPartition) as exc:
        with_oom_retry(boom, backend=port, profile=g10,
                       max_retries=max_retries)()
    assert exc.value.profile.mem_gb == 20.0


def test_migrate_state_moves_every_tensor(weights):
    import torch
    from repro_torch.core.restart import migrate_state
    _, _, _, p = weights
    moved = migrate_state({"params": p, "step": 3}, "meta")
    assert moved["step"] == 3
    assert moved["params"]["layers"]["wq"].device.type == "meta"
    assert moved["params"]["layers"]["wq"].shape == p["layers"]["wq"].shape
    assert isinstance(moved["params"]["final_norm"], torch.Tensor)


def test_engine_refuses_missing_card_and_mixed_devices(weights):
    _, _, cfg, p = weights
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(cfg, p, EngineConfig(), device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(cfg, p, EngineConfig())   # the card is the default
    with pytest.raises(ValueError):
        ServeEngine(cfg, p, EngineConfig(), device="meta")


_SRC_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)",
                         re.MULTILINE)


def test_port_sources_import_no_jax_or_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    offenders = {str(f.relative_to(REPO)): _SRC_IMPORT.findall(f.read_text())
                 for f in files}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert not build._LOADED, 'a kernel library was loaded at import'\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": f"{REPO / 'src'}:{REPO}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_serve_cli_runs_smoke_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "12",
         "--partition-gb", "0.0001"], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "EARLY RESTART" in res.stdout and "1g.10gb" in res.stdout
    assert "24 tokens" in res.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (or no repo beside the script): non-zero exit, no result."""
    import shutil

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env={"PATH": "/usr/bin:/bin"}, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
