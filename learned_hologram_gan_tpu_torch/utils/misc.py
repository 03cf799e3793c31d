"""Miscellaneous parity utilities (reference utilities.py:15-50, 403-487;
counterpart of the JAX package's ``utils/misc.py``)."""

from __future__ import annotations

import zipfile
from typing import List, Union

import numpy as np
import torch


def complex_plain(amplitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """A * exp(i * phi) as complex64 (reference utilities.complex_plain, :15-27)."""
    from ..ops.asm import field

    return field(amplitude, phase)


def phase_tensor_generator(image_path_or_array: Union[str, np.ndarray, torch.Tensor]) -> torch.Tensor:
    """Image file -> (C, H, W) phase map scaled to [0, 2*pi]; an array or a
    tensor passes through as a tensor (reference utilities.phase_tensor_generator,
    :30-50)."""
    if isinstance(image_path_or_array, str):
        from PIL import Image

        img = np.asarray(Image.open(image_path_or_array), dtype=np.float32) / 255.0
        img = img[None] if img.ndim == 2 else np.transpose(img, (2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(img * 2.0 * np.pi))
    if isinstance(image_path_or_array, torch.Tensor):
        return image_path_or_array
    if isinstance(image_path_or_array, np.ndarray):
        return torch.from_numpy(image_path_or_array)
    raise ValueError("The input should be a string or an array.")


def num_devices() -> int:
    """CUDA device count (the reference's num_gpus, utilities.py:403-407)."""
    return torch.cuda.device_count()


def try_device(i: int = 0) -> torch.device:
    """The i-th CUDA device (reference try_gpu, :410-415).  Raises
    ``RuntimeError`` when there is no such device: the port never falls
    back to the CPU on its own; ask for ``torch.device("cpu")`` instead."""
    count = torch.cuda.device_count()
    if i >= count:
        raise RuntimeError(f"CUDA device {i} is not available ({count} visible)")
    return torch.device(f"cuda:{i}")


def devices_info() -> List[str]:
    """Describe every visible CUDA device (reference gpus_info, :431-436)."""
    infos = [f"device {i}: {torch.cuda.get_device_name(i)} (cuda)"
             for i in range(torch.cuda.device_count())]
    for line in infos:
        print(line)
    return infos


def unzip_file(zip_path: str, dest_path: str) -> None:
    """Extract a zip archive (reference utilities.unzip_file, :475-487)."""
    with zipfile.ZipFile(zip_path, "r") as zf:
        zf.extractall(dest_path)
