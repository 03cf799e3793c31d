"""Fused eval-mode UNet forward: BatchNorm folded, residual blocks through
K5 (counterpart of ``learned_hologram_gan_tpu/nn/fused_unet.py``), NHWC.

:func:`unet_apply_fused` walks the port's :class:`~.blocks.UNet` module
(weights as ``convert.generator_state_dict`` carries them), folds every
eval-mode BatchNorm into its conv (:func:`~..ops.cuda.conv_block.fold_conv_bn`)
and runs each residual block through K5's wrapper
(:func:`~..ops.cuda.conv_block.fused_residual_block`): on a CUDA tensor it
launches K5 or raises, on a CPU tensor it runs the same math unfused
(:func:`~..ops.cuda.conv_block.residual_block_reference`).  Pool, up-conv
and head reproduce the module's ops.  ``polyphase_level0`` computes enc_0,
the last up-conv, dec_0 and the head in the space-to-depth phase domain
(:mod:`.polyphase`, exact), where the blocks run unfused, as in the JAX
package.

Inference only: training keeps the module path (batch statistics and
autograd).  The compute dtype is the input's, float32 or bfloat16, as in
the JAX function: BatchNorm folds in float32, the folded weights go to K5
(or its plain version) in the compute dtype with float32 biases, and the
up-convs, the head's 1x1 product and the polyphase primitives take their
weights in it, each output rounded once to it before its bias adds.  Every
product accumulates in float32: float32 convolutions with TF32 off, and
bfloat16 matrix products with cuBLAS's reduced-precision reduction off
(``full_f32_convs``, restored on return).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cuda import conv_block as cb
from .blocks import ResidualBlock, UNet, full_f32_convs
from .polyphase import (
    depth_to_space,
    poly_concat,
    poly_conv1x1,
    poly_conv3x3,
    poly_pool,
    poly_upconv_gemm,
    space_to_depth,
)


def _folded(block: ResidualBlock):
    """(w1, b1, w2, b2, w3, b3) of an eval-mode block, BN folded, in the
    JAX package's layouts (w3 as (Cin, C))."""
    w1, b1 = cb.fold_conv_bn(block.Conv_0, block.BatchNorm_0)
    w2, b2 = cb.fold_conv_bn(block.Conv_1, block.BatchNorm_1)
    w3 = block.Conv_2.weight.detach().float()[:, :, 0, 0].t()
    return w1, b1, w2, b2, w3, block.Conv_2.bias.detach().float()


def _block_eval(block: ResidualBlock, x: torch.Tensor) -> torch.Tensor:
    """One eval-mode ResidualBlock, BN folded, through K5's wrapper."""
    return cb.fused_residual_block(x, *_folded(block))


def _block_eval_poly(block: ResidualBlock, x4: torch.Tensor) -> torch.Tensor:
    """Eval-mode ResidualBlock in the phase domain (BN folded)."""
    w1, b1, w2, b2, w3, b3 = _folded(block)
    y = F.relu(poly_conv3x3(x4, w1, b1))
    y = poly_conv3x3(y, w2, b2)
    return F.relu(y + poly_conv1x1(x4, w3, b3))


def _pixel_shuffle_up(up: torch.nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """The 2x2/stride-2 up-conv of an NHWC tensor in its dtype (the
    module's op: the bias adds after the output rounds)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), up.weight.to(x.dtype), stride=2)
    return y.permute(0, 2, 3, 1) + up.bias.to(x.dtype)


def _flax_up_kernel(up: torch.nn.ConvTranspose2d) -> torch.Tensor:
    """The torch ConvTranspose2d weight (I, O, 2, 2) back in the flax
    (2, 2, I, O) layout that ``lax.conv_transpose`` applies (convert.py)."""
    return up.weight.detach().float().permute(2, 3, 0, 1).flip(0, 1)


def _max_pool(y: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def supported(unet) -> bool:
    """True for a port :class:`~.blocks.UNet` whose residual blocks all
    have their 1x1 shortcut (every UNet the port builds)."""
    return isinstance(unet, UNet) and all(
        m.Conv_2 is not None for m in unet.modules() if isinstance(m, ResidualBlock)
    )


@torch.no_grad()
def unet_apply_fused(
    unet: UNet,
    x: torch.Tensor,
    *,
    polyphase_level0: bool = False,
) -> torch.Tensor:
    """Eval-mode ``UNet.forward`` from the module's weights, NHWC in and out.

    Each residual block goes through K5 on a CUDA tensor and through its
    plain version on a CPU tensor.  The JAX function's ``use_pallas`` has no
    counterpart: it exists because the TPU kernel's VMEM budget refuses most
    blocks, and K5 takes every block the UNet has.  ``polyphase_level0``
    computes level 0 in the space-to-depth phase domain (even H and W; exact
    math).  ``x``'s dtype (float32 or bfloat16) is the compute dtype.
    """
    if not supported(unet):
        raise ValueError("unet_apply_fused: every residual block needs its 1x1 shortcut")
    levels = unet.levels
    skips = []
    poly = polyphase_level0 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
    with full_f32_convs():
        if poly:
            s0 = _block_eval_poly(unet.enc_0, space_to_depth(x))
            skips.append(s0)  # kept in phase layout
            y = poly_pool(s0)
        else:
            y = _block_eval(unet.enc_0, x)
            skips.append(y)
            y = _max_pool(y)
        for i in range(1, levels):
            y = _block_eval(getattr(unet, f"enc_{i}"), y)
            skips.append(y)
            y = _max_pool(y)
        y = _block_eval(unet.bottleneck, y)
        if levels > 1:  # levels == 1: the bottleneck's up IS the final up
            y = _pixel_shuffle_up(unet.ConvTranspose_0, y)
        for i in reversed(range(1, levels)):
            y = torch.cat([skips[i], y], dim=-1)
            y = _block_eval(getattr(unet, f"dec_{i}"), y)
            if i > 1:
                y = _pixel_shuffle_up(getattr(unet, f"ConvTranspose_{levels - i}"), y)
        up = getattr(unet, f"ConvTranspose_{levels - 1}")
        head_w = unet.Conv_0.weight.detach()[:, :, 0, 0].t().to(x.dtype)
        head_b = unet.Conv_0.bias.detach().to(x.dtype)
        if poly:
            y = poly_upconv_gemm(y, _flax_up_kernel(up), up.bias.detach())
            y = poly_concat(skips[0], y)
            y = _block_eval_poly(unet.dec_0, y)
            y = poly_conv1x1(y, head_w, head_b)
            return torch.sigmoid(depth_to_space(y))
        y = _pixel_shuffle_up(up, y)
        y = torch.cat([skips[0], y], dim=-1)
        y = _block_eval(unet.dec_0, y)
        return torch.sigmoid(y @ head_w + head_b)

