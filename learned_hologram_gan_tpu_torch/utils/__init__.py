"""Small utilities: field normalizers, FFT-friendly pads, PNG output, seeding,
the reference's parity helpers, the device timer and the profiler."""

from .fftlen import good_fft_pads, is_smooth, next_fast_len
from .misc import (
    complex_plain,
    devices_info,
    num_devices,
    phase_tensor_generator,
    try_device,
    unzip_file,
)
from .normalize import amplitude_normalizor, tensor_normalizor_2d
from .profiling import annotate, profile_op, trace
from .seed import set_seed
from .timer import device_timer

__all__ = [
    "amplitude_normalizor",
    "annotate",
    "complex_plain",
    "device_timer",
    "devices_info",
    "good_fft_pads",
    "is_smooth",
    "next_fast_len",
    "num_devices",
    "phase_tensor_generator",
    "profile_op",
    "set_seed",
    "tensor_normalizor_2d",
    "trace",
    "try_device",
    "unzip_file",
]
