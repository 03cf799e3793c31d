"""Memmap-backed RGBD dataset over the ``.bin`` files (counterpart of
``learned_hologram_gan_tpu/data/memmap.py``; the inference dataset only).

``.bin`` layout: raw float32, C-order, shape (N, C, H, W), as written by
``ndarray.tofile`` (reference data_processor.py:93-106).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _open_bin(path: str, shape: Tuple[int, int, int, int]) -> np.memmap:
    return np.memmap(path, dtype=np.float32, mode="r", shape=shape)


class ImgDepthDataset:
    """RGBD samples for inference (reference data_loader.py:87-123): the
    image's channels plus the depth map's first channel, (4, H, W) numpy."""

    def __init__(
        self,
        img_path: str,
        depth_path: str,
        samples_num: int = 3800,
        channels_num: int = 3,
        height: int = 192,
        width: int = 192,
    ):
        shape = (samples_num, channels_num, height, width)
        self.num_samples = samples_num
        self.img = _open_bin(img_path, shape)
        self.depth = _open_bin(depth_path, shape)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)) and (idx < 0 or idx >= len(self)):
            raise IndexError("Index out of range")
        return np.concatenate(
            [self.img[idx], self.depth[idx][..., :1, :, :]], axis=-3
        )
