"""Device-accurate timing (counterpart of
``learned_hologram_gan_tpu/utils/timer.py``; the reference's
``utilities.gpu_timer``, utilities.py:447-472).

:func:`device_timer` times ``operation`` over ``repeat`` runs after
``warmup`` runs.  Where the result holds a CUDA tensor it times with CUDA
events recorded on the current stream around the runs (device time; the
enqueue alone would be what a host clock measures); otherwise it takes
the host clock and materializes the last result.  A CPU time is the host's
and is never a device number.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch


def _tensors(result) -> List[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        return [result]
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return [t for r in result for t in _tensors(r)]
    return []


def _materialize(result) -> None:
    """Wait for every tensor of ``result``: synchronize the CUDA devices it
    lies on, and read one element of each on the host."""
    for t in _tensors(result):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        if t.numel():
            t.reshape(-1)[:1].abs().cpu()


def device_timer(operation: Callable[[], object], repeat: int = 100, warmup: int = 2) -> float:
    """Mean latency of ``operation`` in milliseconds over ``repeat`` runs:
    CUDA events on a CUDA result, the host clock otherwise."""
    for _ in range(warmup):
        _materialize(operation())
    events = None
    if torch.cuda.is_available():
        events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        events[0].record()
    begin = time.perf_counter()
    out = None
    for _ in range(repeat):
        out = operation()
    if events is not None and any(t.is_cuda for t in _tensors(out)):
        events[1].record()
        events[1].synchronize()
        _materialize(out)
        return events[0].elapsed_time(events[1]) / repeat
    _materialize(out)
    return (time.perf_counter() - begin) * 1e3 / repeat
