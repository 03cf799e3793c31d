"""Build the package's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
nvcc alone (no PyTorch headers, so a build takes seconds) into
``_build/<name>-<hash>.so``, where the hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags: a second run with the same sources
loads the existing library.  The build happens at first use, never at
import; :func:`build_jobs` runs one nvcc per (source, macros) pair, as many
at once as the host has cores.
``defines`` adds preprocessor macros (and so a library of another hash):
K1's and K3's wrappers load one library for the power-of-two FFT plans and
one per plan of any other length, its plan compiled in
(``fft_plan.build_defines``); ``fft_ablation.py`` and ``k5_ablation.py``
ask for measurement builds and candidate plans.
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
from typing import Dict, Sequence, Tuple

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
    # (kept beside the library as <name>-<hash>.log, and read back when cached)


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


def _flags(defines: Sequence[str]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines: Sequence[str]) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    blob = source.read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        blob += b"\0" + header.name.encode() + b"\0" + header.read_bytes()
    digest = hashlib.sha256(blob + "\0".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_jobs(jobs: Sequence[Tuple[str, Sequence[str]]]) -> Dict[Tuple[str, Tuple[str, ...]], BuildResult]:
    """Compile each ``(name, defines)``: ``csrc/<name>.cu`` with the macros
    ``defines``, unless a library of the same hash exists; one nvcc process
    per job, as many at a time as the host has cores.  Keyed by
    ``(name, tuple(defines))``."""
    results: Dict[Tuple[str, Tuple[str, ...]], BuildResult] = {}
    pending = []
    for name, defines in jobs:
        key = (name, tuple(defines))
        if key in results or any(key == p[0] for p in pending):
            continue
        target = _target(name, defines)
        if target.exists():
            log = target.with_suffix(".log")
            results[key] = BuildResult(target, 0.0, True, log.read_text() if log.exists() else "")
        else:
            pending.append((key, target))
    limit = os.cpu_count() or 1
    running = []
    failures = []

    def finish(job):
        key, source, target, tmp, proc, start = job
        log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {source} {' '.join(key[1])} (exit {proc.returncode}):\n{log}")
            return
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
        results[key] = BuildResult(target, time.perf_counter() - start, False, log)

    try:
        for key, target in pending:
            while len(running) >= limit:
                done = next((job for job in running if job[4].poll() is not None), None)
                if done is None:
                    time.sleep(0.05)
                    continue
                running.remove(done)
                finish(done)
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            source = CSRC_DIR / f"{key[0]}.cu"
            proc = subprocess.Popen(
                [find_nvcc(), *_flags(key[1]), "-o", tmp, str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            running.append((key, source, target, tmp, proc, time.perf_counter()))
        while running:
            finish(running.pop(0))
    finally:
        for _, _, _, tmp, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for _, _, _, tmp, _, _ in running:
            if os.path.exists(tmp):
                os.remove(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def build_libraries(names: Sequence[str], defines: Sequence[str] = ()) -> Dict[str, BuildResult]:
    """Compile each ``csrc/<name>.cu`` with ``defines`` whose library of the
    same hash does not exist yet, one nvcc process per source."""
    built = build_jobs([(name, defines) for name in names])
    return {name: built[(name, tuple(defines))] for name in names}


def build_library(name: str, defines: Sequence[str] = ()) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    return build_libraries([name], defines)[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build_library(name, defines).path))
