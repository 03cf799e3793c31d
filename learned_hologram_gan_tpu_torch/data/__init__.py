"""Datasets over the MIT-CGH-4K ``.bin`` files, the epoch loader, the
device-resident datasets and the EXR -> ``.bin`` conversion."""

from .device import RotatingDeviceDataset, dataset_to_device, device_epoch_loader
from .exr import DataConverterExr2Bin, get_files_in_dir, read_exr, read_exr_in_multi_folders
from .memmap import AmpPhsDataset, ImgDepthAmpPhsDataset, ImgDepthDataset, batch_indices, gather_batch
from .prefetch import epoch_loader

__all__ = [
    "AmpPhsDataset",
    "DataConverterExr2Bin",
    "ImgDepthAmpPhsDataset",
    "ImgDepthDataset",
    "RotatingDeviceDataset",
    "batch_indices",
    "dataset_to_device",
    "device_epoch_loader",
    "epoch_loader",
    "gather_batch",
    "get_files_in_dir",
    "read_exr",
    "read_exr_in_multi_folders",
]
