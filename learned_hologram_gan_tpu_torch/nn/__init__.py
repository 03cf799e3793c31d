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
    remat,
)
from .fused_unet import unet_apply_fused
from .polyphase import (
    depth_to_space,
    poly_concat,
    poly_conv1x1,
    poly_conv3x3,
    poly_pool,
    poly_upconv_gemm,
    space_to_depth,
    tile4,
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
    "remat",
    "depth_to_space",
    "poly_concat",
    "poly_conv1x1",
    "poly_conv3x3",
    "poly_pool",
    "poly_upconv_gemm",
    "space_to_depth",
    "tile4",
    "unet_apply_fused",
]
