"""Build the package's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
nvcc alone (no PyTorch headers, so a build takes seconds) into
``_build/<name>-<hash>.so``, where the hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags: a second run with the same sources
loads the existing library.  The build happens at first use, never at
import; :func:`build_libraries` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float
    cached: bool
    log: str  # nvcc's output, including ptxas' register / shared-memory report


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, then ``/usr/local/cuda/bin``, then ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def _target(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    blob = source.read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        blob += b"\0" + header.name.encode() + b"\0" + header.read_bytes()
    digest = hashlib.sha256(blob + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_libraries(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Compile each ``csrc/<name>.cu`` whose library of the same hash does
    not exist yet, one nvcc process per source, all started together."""
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        target = _target(name)
        if target.exists():
            results[name] = BuildResult(target, 0.0, True, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        source = CSRC_DIR / f"{name}.cu"
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, source, target, tmp, proc, time.perf_counter()))
    failures = []
    try:
        for name, source, target, tmp, proc, start in running:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, target)
            results[name] = BuildResult(target, time.perf_counter() - start, False, log)
    finally:
        for _, _, _, tmp, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def build_library(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    return build_libraries([name])[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build_library(name).path))
