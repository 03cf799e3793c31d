"""Datasets over the MIT-CGH-4K ``.bin`` files, the epoch loader and the
device-resident datasets."""

from .device import RotatingDeviceDataset, dataset_to_device, device_epoch_loader
from .memmap import AmpPhsDataset, ImgDepthAmpPhsDataset, ImgDepthDataset, batch_indices, gather_batch
from .prefetch import epoch_loader

__all__ = [
    "AmpPhsDataset",
    "ImgDepthAmpPhsDataset",
    "ImgDepthDataset",
    "RotatingDeviceDataset",
    "batch_indices",
    "dataset_to_device",
    "device_epoch_loader",
    "epoch_loader",
    "gather_batch",
]
