"""Datasets over the MIT-CGH-4K ``.bin`` files."""

from .memmap import ImgDepthDataset

__all__ = ["ImgDepthDataset"]
