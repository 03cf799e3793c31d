"""Datasets over the MIT-CGH-4K ``.bin`` files and the epoch loader."""

from .memmap import AmpPhsDataset, ImgDepthAmpPhsDataset, ImgDepthDataset, batch_indices, gather_batch
from .prefetch import epoch_loader

__all__ = [
    "AmpPhsDataset",
    "ImgDepthAmpPhsDataset",
    "ImgDepthDataset",
    "batch_indices",
    "epoch_loader",
    "gather_batch",
]
