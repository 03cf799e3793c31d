"""Neural-net building blocks."""

from .blocks import (
    BatchNorm,
    ChannelWiseSymmetricConv,
    FakeChannelWiseSymmetricConv,
    PixelShuffleConvTranspose,
    ResidualBlock,
    SymmetricConv2d,
    UNet,
    frozen_batch_stats,
    full_f32_convs,
    init_weights,
)

__all__ = [
    "BatchNorm",
    "ChannelWiseSymmetricConv",
    "FakeChannelWiseSymmetricConv",
    "PixelShuffleConvTranspose",
    "ResidualBlock",
    "SymmetricConv2d",
    "UNet",
    "frozen_batch_stats",
    "full_f32_convs",
    "init_weights",
]
