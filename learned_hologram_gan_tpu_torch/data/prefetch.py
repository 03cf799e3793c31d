"""Host epoch loader (counterpart of
``learned_hologram_gan_tpu/data/prefetch.py:61-94``).

Batches are gathered from the memmap on the host and moved to the device
from pinned memory with a non-blocking copy, so the copy of a batch
overlaps the device work queued before it.  Under a data mesh
(``sharding``) each rank gathers only its rows of the same seeded global
batch.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from .memmap import batch_indices, gather_batch


def _to_device(array, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def epoch_loader(
    dataset,
    batch_size: int,
    *,
    shuffle: bool,
    drop_last: bool,
    seed: Optional[int] = None,
    device: str | torch.device = "cuda",
    sharding=None,
) -> Iterator:
    """One epoch of batches of ``dataset`` as tensors on ``device``: a tuple
    of tensors for multi-tensor datasets, else one tensor.  ``sharding`` (a
    ``parallel.batch_sharding``) keeps this rank's rows of each global
    batch."""
    device = torch.device(device)
    for idx in batch_indices(len(dataset), batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed):
        if sharding is not None:
            idx = idx[sharding.rows(len(idx))]
        batch = gather_batch(dataset, idx)
        if isinstance(batch, tuple):
            yield tuple(_to_device(a, device) for a in batch)
        else:
            yield _to_device(batch, device)
