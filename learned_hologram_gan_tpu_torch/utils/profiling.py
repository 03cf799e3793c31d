"""Profiling and tracing (counterpart of
``learned_hologram_gan_tpu/utils/profiling.py``, over ``torch.profiler``
where the JAX package uses ``jax.profiler``).

* :func:`trace`: a context manager that records host and, where a card
  is present, CUDA activity and writes a Chrome trace (``trace.json``)
  into ``log_dir``; the profile itself is on the context object
  (``.profile``) for ``key_averages()``.  Where it records CUDA activity
  it waits for the block's kernels, and a trace that lacks any kernel the
  block launched raises (:func:`check_kernels`) rather than pass for a
  profile: on a card host whose device timestamps drift from the host
  clock the profiler drops device events (PERF.md §7).
* :func:`annotate`: a named host region on the timeline
  (``torch.profiler.record_function``).
* :func:`profile_op`: trace a callable for a few steps, each step under
  ``step_i``, and return the trace directory.

``utils/cuda_measure.py`` keeps the kernel timings and bounds the smoke
scripts print.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Iterator

import torch

TRACE_FILE = "trace.json"


class _Trace:
    profile = None


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[_Trace]:
    """Profile the block; write ``log_dir/trace.json`` (Chrome trace format,
    chrome://tracing or Perfetto) when it ends."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handle = _Trace()
    cuda = torch.profiler.ProfilerActivity.CUDA in activities
    with torch.profiler.profile(activities=activities) as prof:
        handle.profile = prof
        yield handle
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if cuda:
        check_kernels(path)


def check_kernels(path: str) -> int:
    """The kernel events of the Chrome trace at ``path``.  Raises if a
    kernel launch it holds (a CUDA runtime or driver call) has no kernel
    event of the same correlation id: the device side of the profile was
    lost, in part or whole."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    launched = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", "")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    missing = launched - {e.get("args", {}).get("correlation") for e in kernels}
    if missing:
        raise RuntimeError(f"{path}: {len(missing)} of {len(launched)} traced kernel launches have no "
                           "kernel event: the profiler lost the device side of the trace")
    return len(kernels)


def annotate(name: str):
    """Named region for the profiler timeline (a context manager)."""
    return torch.profiler.record_function(name)


def profile_op(operation: Callable[[], object], log_dir: str, steps: int = 3, warmup: int = 1) -> str:
    """Run ``operation`` under the profiler, each step annotated ``step_i``;
    returns the trace directory."""
    from .timer import _materialize

    for _ in range(warmup):
        _materialize(operation())
    with trace(log_dir):
        out = None
        for i in range(steps):
            with annotate(f"step_{i}"):
                out = operation()
        _materialize(out)
    return log_dir
