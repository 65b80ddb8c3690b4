"""The import guard, and that a run refuses to run off the card."""

from __future__ import annotations

import subprocess
import sys

from portbench import guard
from portbench.harness import ROOT


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.models",
                                    "jax_like", "reprox", "torch"]) == []
    assert guard.forbidden_modules(["repro.core", "repro_torch"]) == ["repro"]
    assert guard.forbidden_modules(["jaxlib.xla_client", "jax", "flax.nn",
                                    "numpy"]) == ["flax", "jax", "jaxlib"]


def test_a_small_run_loads_nothing_of_the_jax_side():
    """The harness, the program and the reference, driven through a whole
    run on the CPU in a fresh process, leave no forbidden module loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import guard, testing\n"
        "out = testing.run_small(testing.small_cell("
        "'mamba2-2.7b.decode_chat'), 3)\n"
        "assert out.correct, out.checks\n"
        "print(guard.forbidden_modules(sys.modules))\n"
        % (str(ROOT), str(ROOT / "src")))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_the_card_exits_nonzero_and_prints_no_result():
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mamba2-2.7b.decode_chat", "--seed", "2200000017", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "is_available() is False" in done.stderr
