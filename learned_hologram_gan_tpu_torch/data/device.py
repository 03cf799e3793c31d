"""Device-resident datasets: upload once, gather batches on the device
(counterpart of ``learned_hologram_gan_tpu/data/device.py``).

A dataset that fits in device memory is uploaded field by field once; each
batch is then an ``index_select`` of the resident tensors, and the only
per-batch host-to-device traffic is the index vector.  ``dtype`` stores
the resident tensors narrower (``torch.bfloat16`` halves the footprint;
float32 -> bfloat16 rounds to nearest even, as numpy's ``ml_dtypes``
conversion in the JAX package does, so both hold the same bits).
:class:`RotatingDeviceDataset` keeps one contiguous shard resident at a
time for sets larger than the device allows.  The streaming
:func:`~.prefetch.epoch_loader` remains for everything else.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .memmap import batch_indices


def dataset_to_device(
    dataset,
    dtype: Optional[torch.dtype] = None,
    device: str | torch.device = "cuda",
) -> Tuple[torch.Tensor, ...]:
    """Every sample of ``dataset`` stacked per field and moved to ``device``:
    a tuple of (N, ...) tensors in ``dtype`` (float32 by default).

    Fields come from the dataset's own ``get()``, so they are what the
    streaming loader yields.  The host holds one copy of the dataset while
    it uploads, converted to ``dtype`` sample by sample."""
    n = len(dataset)
    first = dataset.get(0)
    if not isinstance(first, tuple):
        first = (first,)
    dtype = torch.float32 if dtype is None else dtype
    bufs = [torch.empty((n,) + np.shape(f), dtype=dtype) for f in first]
    for i in range(n):
        sample = dataset.get(i)
        if not isinstance(sample, tuple):
            sample = (sample,)
        for buf, f in zip(bufs, sample):
            buf[i] = torch.from_numpy(np.array(f, dtype=np.float32))
    return tuple(b.to(device) for b in bufs)


def device_epoch_loader(
    arrays: Tuple[torch.Tensor, ...],
    batch_size: int,
    *,
    shuffle: bool,
    drop_last: bool,
    seed: Optional[int] = None,
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """One epoch of batches gathered on the device from resident ``arrays``,
    in the order of :func:`~.memmap.batch_indices` (the streaming loader's
    and the JAX package's for the same seed)."""
    n = arrays[0].shape[0]
    device = arrays[0].device
    for idx in batch_indices(n, batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed):
        ii = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
        yield tuple(a.index_select(0, ii) for a in arrays)


class _DatasetSlice:
    """Contiguous index-range view of a host dataset (same ``get``)."""

    def __init__(self, dataset, lo: int, hi: int):
        self._dataset, self._lo, self._hi = dataset, lo, hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def get(self, i: int):
        return self._dataset.get(self._lo + i)


class RotatingDeviceDataset:
    """Device residency for datasets larger than the device can hold next
    to the train step.

    Sample indices split into ``shards`` contiguous blocks, and one block is
    resident at a time.  Epochs run on shards in ``block_epochs``-epoch
    runs (A, A, B, B, A, A, ... for ``shards=2, block_epochs=2``), so an
    upload serves several epochs; each epoch shuffles within its shard.
    A swap drops the old shard's tensors before the next upload, so the
    peak is one shard (the caching allocator reuses the freed blocks).
    """

    def __init__(self, dataset, shards: int = 2, dtype: Optional[torch.dtype] = None,
                 block_epochs: int = 2, device: str | torch.device = "cuda"):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.shards = shards
        self.block_epochs = block_epochs
        self._dtype = dtype
        self._device = device
        n = len(dataset)
        bounds = np.linspace(0, n, shards + 1).astype(int)
        self._slices = [
            _DatasetSlice(dataset, int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])
        ]
        self._resident: Optional[Tuple[int, Tuple[torch.Tensor, ...]]] = None

    def shard_for_epoch(self, epoch: int) -> int:
        return (epoch // self.block_epochs) % self.shards

    def arrays_for_epoch(self, epoch: int) -> Tuple[torch.Tensor, ...]:
        """The resident tensors of ``epoch``'s shard, swapped in as needed."""
        s = self.shard_for_epoch(epoch)
        if self._resident is not None and self._resident[0] == s:
            return self._resident[1]
        self.evict()  # free the old shard BEFORE the next upload
        arrays = dataset_to_device(self._slices[s], dtype=self._dtype, device=self._device)
        self._resident = (s, arrays)
        return arrays

    def epoch_loader(self, batch_size: int, epoch: int, *, shuffle: bool = True,
                     drop_last: bool = True, seed: Optional[int] = None):
        return device_epoch_loader(
            self.arrays_for_epoch(epoch), batch_size,
            shuffle=shuffle, drop_last=drop_last, seed=seed,
        )

    def evict(self) -> None:
        """Drop the resident shard; the next ``arrays_for_epoch`` uploads
        again."""
        self._resident = None
