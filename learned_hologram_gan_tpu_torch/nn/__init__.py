"""Neural-net building blocks."""

from .blocks import (
    ChannelWiseSymmetricConv,
    FakeChannelWiseSymmetricConv,
    PixelShuffleConvTranspose,
    ResidualBlock,
    SymmetricConv2d,
    UNet,
    init_weights,
)

__all__ = [
    "ChannelWiseSymmetricConv",
    "FakeChannelWiseSymmetricConv",
    "PixelShuffleConvTranspose",
    "ResidualBlock",
    "SymmetricConv2d",
    "UNet",
    "init_weights",
]
