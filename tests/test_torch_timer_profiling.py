"""The port's ``utils/timer.py`` and ``utils/profiling.py`` on the CPU.

``device_timer`` takes the host clock where the result lies on the CPU
(CUDA events where it lies on a card, which only the card run shows); it
counts the warm-up runs apart from the timed ones, as the JAX package's
does.  ``profile_op`` writes a Chrome trace that holds its ``step_i``
annotations, the counterpart of the JAX package's profile directory.
"""

import json
import os

import torch

from learned_hologram_gan_tpu_torch.utils import annotate, device_timer, profile_op, trace
import pytest

from learned_hologram_gan_tpu_torch.utils.profiling import TRACE_FILE, check_kernels


def test_device_timer_counts_runs_and_returns_ms():
    calls = []

    def op():
        calls.append(1)
        return torch.ones(4) * len(calls)

    ms = device_timer(op, repeat=5, warmup=3)
    assert len(calls) == 8
    assert ms >= 0.0 and isinstance(ms, float)


def test_device_timer_measures_host_time_on_the_cpu():
    import time

    def op():
        time.sleep(0.01)
        return torch.zeros(2)

    assert device_timer(op, repeat=3, warmup=0) >= 9.0


def test_device_timer_takes_nested_results():
    assert device_timer(lambda: {"a": (torch.ones(3), [torch.zeros(1)])}, repeat=2, warmup=1) >= 0.0


def test_profile_op_writes_a_trace_with_its_steps(tmp_path):
    log_dir = str(tmp_path / "prof")
    out = profile_op(lambda: torch.rand(16, 16) @ torch.rand(16, 16), log_dir, steps=3, warmup=1)
    assert out == log_dir
    events = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"step_0", "step_1", "step_2"} <= names
    assert any("mm" in (n or "") for n in names)


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path)) as t:
        with annotate("region_a"):
            torch.fft.fft(torch.rand(8, dtype=torch.complex64))
    assert t.profile is not None
    assert "region_a" in {e.key for e in t.profile.key_averages()}
    assert os.path.exists(tmp_path / TRACE_FILE)


@pytest.mark.parametrize("cat", ["cuda_runtime", "cuda_driver"])
def test_check_kernels_refuses_a_trace_that_lost_its_kernels(tmp_path, cat):
    """A trace whose kernel launches lack their kernel events, all or some,
    raises; with every kernel, or with no launch at all, it counts them."""
    name = "cudaLaunchKernel" if cat == "cuda_runtime" else "cuLaunchKernel"

    def launch(i):
        return {"cat": cat, "name": name, "args": {"correlation": i}}

    def kernel(i):
        return {"cat": "kernel", "name": "fft_axis_kernel<32, false>", "args": {"correlation": i}}

    path = tmp_path / "trace.json"
    for events in ([launch(1), launch(2), {"cat": "cpu_op", "name": "aten::mm"}],
                   [launch(1), launch(2), kernel(2)]):
        path.write_text(json.dumps({"traceEvents": events}))
        with pytest.raises(RuntimeError, match="lost the device side"):
            check_kernels(str(path))
    path.write_text(json.dumps({"traceEvents": [launch(1), launch(2), kernel(1), kernel(2)]}))
    assert check_kernels(str(path)) == 2
    path.write_text(json.dumps({"traceEvents": [{"cat": "cpu_op", "name": "aten::mm"}]}))
    assert check_kernels(str(path)) == 0
