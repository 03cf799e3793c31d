"""Small utilities: field normalizers and PNG output."""

from .normalize import amplitude_normalizor, tensor_normalizor_2d

__all__ = [
    "amplitude_normalizor",
    "tensor_normalizor_2d",
]
