"""Memmap-backed datasets over the ``.bin`` files (counterpart of
``learned_hologram_gan_tpu/data/memmap.py``).

``.bin`` layout: raw float32, C-order, shape (N, C, H, W), as written by
``ndarray.tofile`` (reference data_processor.py:93-106).  Phase bins hold
phase normalized to [0, 1]; the consumer scales by 2*pi where the reference
does.  Datasets return numpy; :mod:`.prefetch` batches and moves them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def _open_bin(path: str, shape: Tuple[int, int, int, int]) -> np.memmap:
    return np.memmap(path, dtype=np.float32, mode="r", shape=shape)


class _MemmapDataset:
    """Base: indexable + length, numpy outputs."""

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)) and (idx < 0 or idx >= len(self)):
            raise IndexError("Index out of range")
        return self.get(idx)


class ImgDepthAmpPhsDataset(_MemmapDataset):
    """(RGBD, amp, phs) triplets (reference data_loader.py:8-52); RGBD is
    the image's channels plus the depth map's first channel."""

    def __init__(
        self,
        img_path: str,
        depth_path: str,
        amp_path: str,
        phs_path: str,
        samples_num: int = 3800,
        channels_num: int = 3,
        height: int = 192,
        width: int = 192,
    ):
        shape = (samples_num, channels_num, height, width)
        self.num_samples = samples_num
        self.img = _open_bin(img_path, shape)
        self.depth = _open_bin(depth_path, shape)
        self.amp = _open_bin(amp_path, shape)
        self.phs = _open_bin(phs_path, shape)

    def get(self, idx):
        rgbd = np.concatenate([self.img[idx], self.depth[idx][..., :1, :, :]], axis=-3)
        return rgbd, np.asarray(self.amp[idx]), np.asarray(self.phs[idx])


class AmpPhsDataset(_MemmapDataset):
    """(amp, 2*pi*phs) pairs for AP2POH pretraining (reference
    data_loader.py:55-84): the phase is scaled to radians here, once."""

    def __init__(
        self,
        amp_path: str,
        phs_path: str,
        samples_num: int = 3800,
        channels_num: int = 3,
        height: int = 192,
        width: int = 192,
    ):
        shape = (samples_num, channels_num, height, width)
        self.num_samples = samples_num
        self.amp = _open_bin(amp_path, shape)
        self.phs = _open_bin(phs_path, shape)

    def get(self, idx):
        return np.asarray(self.amp[idx]), 2.0 * np.pi * np.asarray(self.phs[idx])


class ImgDepthDataset(_MemmapDataset):
    """RGBD samples for inference (reference data_loader.py:87-123), (4, H, W)."""

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

    def get(self, idx):
        return np.concatenate([self.img[idx], self.depth[idx][..., :1, :, :]], axis=-3)


def batch_indices(
    num_samples: int,
    batch_size: int,
    *,
    shuffle: bool,
    drop_last: bool,
    seed: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Epoch index batches (the reference's DataLoader semantics: shuffle and
    drop_last for train, ordered for val, trainingModel.py:32-57).  The same
    numpy shuffle as the JAX package, so both draw the same batches."""
    order = np.arange(num_samples)
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(order)
    end = (num_samples // batch_size) * batch_size if drop_last else num_samples
    for start in range(0, end, batch_size):
        yield order[start : start + batch_size]


def gather_batch(dataset: _MemmapDataset, idx: Sequence[int]):
    """Stack dataset[i] for i in idx into batched numpy arrays."""
    samples = [dataset.get(int(i)) for i in idx]
    if isinstance(samples[0], tuple):
        return tuple(np.stack(parts) for parts in zip(*samples))
    return np.stack(samples)
