"""Small utilities: field normalizers, FFT-friendly pads and PNG output."""

from .fftlen import good_fft_pads, is_smooth, next_fast_len
from .normalize import amplitude_normalizor, tensor_normalizor_2d

__all__ = [
    "amplitude_normalizor",
    "good_fft_pads",
    "is_smooth",
    "next_fast_len",
    "tensor_normalizor_2d",
]
