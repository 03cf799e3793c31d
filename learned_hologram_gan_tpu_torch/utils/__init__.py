"""Small utilities: field normalizers, FFT-friendly pads, PNG output, seeding
and the reference's parity helpers."""

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
from .seed import set_seed

__all__ = [
    "amplitude_normalizor",
    "complex_plain",
    "devices_info",
    "good_fft_pads",
    "is_smooth",
    "next_fast_len",
    "num_devices",
    "phase_tensor_generator",
    "set_seed",
    "tensor_normalizor_2d",
    "try_device",
    "unzip_file",
]
