#!/usr/bin/env python
"""Warming-up study: a ResNet-18-shaped classifier from the port's blocks
(the port's counterpart of ``examples/warming_up_resnet.py``).

An executable version of the reference's ``warmingUp/aboutResNet18.ipynb``
(a torch ResNet-18 tutorial on FashionMNIST): the classic [2, 2, 2, 2]-stage
residual classifier assembled from :class:`~..nn.blocks.ResidualBlock`,
the block the hologram UNet and critic use, fit to a synthetic 4-class
texture problem with plain Adam steps.  It shows the blocks are general::

    python -m learned_hologram_gan_tpu_torch.examples.warming_up_resnet [--steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def synthetic_textures(rng, n, size=32):
    """4 classes: vertical stripes, horizontal stripes, checks, blobs; NHWC
    float32 images and int labels (the JAX example's draws)."""
    x = np.zeros((n, size, size, 1), np.float32)
    y = rng.integers(0, 4, size=n)
    g = np.arange(size)
    for i, cls in enumerate(y):
        phase = rng.uniform(0, 2 * np.pi)
        f = rng.uniform(2, 5)
        if cls == 0:
            img = np.repeat(np.sin(f * 2 * np.pi * g[None, :] / size + phase), size, axis=0)
        elif cls == 1:
            img = np.repeat(np.sin(f * 2 * np.pi * g[:, None] / size + phase), size, axis=1)
        elif cls == 2:
            img = np.sin(f * 2 * np.pi * g[None, :] / size + phase) * np.sin(f * 2 * np.pi * g[:, None] / size + phase)
        else:
            img = rng.normal(size=(size, size))
            k = np.exp(-0.5 * ((g - size / 2) / 2.0) ** 2)
            img = np.real(np.fft.ifft2(np.fft.fft2(img) * np.outer(k, k)))
            img /= max(np.abs(img).max(), 1e-6)
        x[i, :, :, 0] = img + 0.05 * rng.normal(size=(size, size))
    return x, y.astype(np.int64)


class ResNet18(nn.Module):
    """[2, 2, 2, 2] residual stages, width w -> 8w, global-average-pool
    head: the notebook's architecture from the port's ResidualBlock."""

    def __init__(self, num_classes: int = 4, width: int = 16):  # 64 in the real ResNet-18
        super().__init__()
        from ..nn.blocks import ResidualBlock, _batch_norm, _conv

        w = width
        self.stem = _conv(1, w, 3)  # CIFAR-style stem
        self.stem_bn = _batch_norm(w)
        blocks, cin = [], w
        for stage, feats in enumerate([w, 2 * w, 4 * w, 8 * w]):
            for blk in range(2):
                stride = 2 if stage > 0 and blk == 0 else 1
                blocks.append(ResidualBlock(cin, feats, use_1x1conv=stride != 1 or (blk == 0 and stage > 0),
                                            strides=stride))
                cin = feats
        self.blocks = nn.Sequential(*blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(x)))
        x = self.blocks(x)
        return self.head(x.mean(dim=(2, 3)))  # global average pool


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train and test; returns the first and last losses and the test
    accuracy."""
    from ..nn.blocks import _TRUNC_STD, init_weights

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="torch device to run on (cuda unless asked otherwise)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")

    rng = np.random.default_rng(0)
    x_train, y_train = synthetic_textures(rng, 512)
    x_test, y_test = synthetic_textures(rng, 256)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)

    model = ResNet18()
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    # the stem conv and the head keep flax's default lecun_normal, as in the
    # JAX example (nn.Conv / nn.Dense): the stem's output then has about unit
    # variance, near BatchNorm's initial running variance, which a few
    # hundred steps at momentum 0.99 do not move far
    with torch.no_grad():
        for layer in (model.stem, model.head):
            fan_in = layer.weight[0].numel()
            torch.nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0, generator=gen)
            layer.weight.mul_((1.0 / fan_in) ** 0.5 / _TRUNC_STD)
            layer.bias.zero_()
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    bsz = 64
    first_loss = None
    model.train()
    for i in range(args.steps):
        idx = rng.integers(0, len(x_train), bsz)
        loss = F.cross_entropy(model(nchw(x_train[idx])), torch.from_numpy(y_train[idx]).to(device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if first_loss is None:
            first_loss = float(loss.detach())
        if (i + 1) % 50 == 0:
            print(f"step {i + 1}: loss {float(loss.detach()):.4f}")

    model.eval()
    with torch.no_grad():
        logits = model(nchw(x_test))
        acc = float((logits.argmax(-1).cpu() == torch.from_numpy(y_test)).float().mean())
    last_loss = float(loss.detach())
    print(f"test accuracy after {args.steps} steps: {acc:.3f} (loss {first_loss:.3f} -> {last_loss:.3f})")
    assert last_loss < first_loss, "training must reduce the loss"
    assert acc > 0.6, f"ResNet18 should separate the 4 textures, got {acc}"
    print("warming-up ResNet study: all assertions passed")
    return dict(first_loss=first_loss, last_loss=last_loss, accuracy=acc)


if __name__ == "__main__":
    main()
