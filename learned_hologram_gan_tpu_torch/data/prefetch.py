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


def _to_device(array, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = torch.from_numpy(array)
    if dtype is not None:  # on the host, before the copy
        t = t.to(dtype)
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
    dtype: Optional[torch.dtype] = None,
) -> Iterator:
    """One epoch of batches of ``dataset`` as tensors on ``device``: a tuple
    of tensors for multi-tensor datasets, else one tensor.  ``sharding`` (a
    ``parallel.batch_sharding``) keeps this rank's rows of each global
    batch.  ``dtype`` casts each batch on the host before the copy
    (``torch.bfloat16`` halves the bytes moved; float32 -> bfloat16 rounds
    to nearest even, as the JAX package's host cast does)."""
    device = torch.device(device)
    for idx in batch_indices(len(dataset), batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed):
        if sharding is not None:
            idx = idx[sharding.rows(len(idx))]
        batch = gather_batch(dataset, idx)
        if isinstance(batch, tuple):
            yield tuple(_to_device(a, device, dtype) for a in batch)
        else:
            yield _to_device(batch, device, dtype)
