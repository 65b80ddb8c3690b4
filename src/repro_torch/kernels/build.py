"""Build the CUDA sources under ``csrc/`` with nvcc, at first use.

Each source has a plain C interface and becomes its own shared library,
loaded with ctypes (no PyTorch headers, so a build takes seconds).  The
libraries go to ``build/repro_torch/`` at the root of the checkout, named
by a hash of the source and flags so an edited source is rebuilt.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: every kernel source of the package, by library name
SOURCES = ("flash_attention", "flash_attention_sm90", "ssd_scan",
           "ssd_scan_sm90", "ssm_state_update")

_LOADED: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    log: str              # nvcc and ptxas output ("" when already built)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels build only where the toolkit is")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(
        src.read_bytes() + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{key}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, BuildResult]:
    """Compile every named source not built yet, one nvcc each, all started
    together.  Raises with nvcc's output if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            results[name] = BuildResult(name, out, "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built if needed and loaded once."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build((name,))[name].path))
    return _LOADED[name]
