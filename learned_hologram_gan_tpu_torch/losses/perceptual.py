"""VGG19 perceptual loss (counterpart of
``learned_hologram_gan_tpu/losses/perceptual.py``; reference loss_func.py:12-63).

torchvision VGG19's feature trunk up to relu5_2, tapping relu1_2, relu2_2,
relu3_2, relu4_2 and relu5_2 (torchvision ``features`` indices 3, 8, 13, 22,
31), with ImageNet normalization and the mean over taps of the per-tap MSE.
The convs carry the flax names ``conv_0``..``conv_13``.

Weights come from the ``.npz`` layout the JAX package reads (``conv_{i}_kernel``
HWIO, ``conv_{i}_bias``; written by ``tools/convert_vgg19.py``), read with
numpy.  There is no silent fallback: ``vgg19`` without a weights file raises,
and a fixed random VGG19 is only the explicit opt-in ``mode="random"``.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (convs_in_stage, channels); each tap follows the 2nd conv of a stage
_STAGES: Tuple[Tuple[int, int], ...] = ((2, 64), (2, 128), (4, 256), (4, 512), (2, 512))
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_TRUNC_STD = 0.87962566103423978

DEFAULT_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights",
    "vgg19_features.npz",
)


class VGG19Features(nn.Module):
    """VGG19 trunk through relu5_2: (B, 3, H, W) in [0, 1] -> the 5 taps."""

    def __init__(self):
        super().__init__()
        cin, idx = 3, 0
        for n_convs, feats in _STAGES:
            for _ in range(n_convs):
                setattr(self, f"conv_{idx}", nn.Conv2d(cin, feats, 3, padding=1))
                cin, idx = feats, idx + 1
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - self.mean) / self.std
        taps, idx = [], 0
        for stage_i, (n_convs, _) in enumerate(_STAGES):
            if stage_i > 0:
                x = F.max_pool2d(x, 2)
            for c in range(n_convs):
                x = F.relu(getattr(self, f"conv_{idx}")(x))
                idx += 1
                if c == 1:
                    taps.append(x.float())
                    if stage_i == len(_STAGES) - 1:
                        return taps
        return taps


def vgg19_tree_from_npz(path: str) -> dict:
    """The ``.npz`` layout as a flax-style ``{"conv_i": {"kernel", "bias"}}``
    tree of numpy arrays."""
    with np.load(path) as raw:
        tree, i = {}, 0
        while f"conv_{i}_kernel" in raw:
            tree[f"conv_{i}"] = {"kernel": raw[f"conv_{i}_kernel"], "bias": raw[f"conv_{i}_bias"]}
            i += 1
    return tree


@torch.no_grad()
def _random_init(model: VGG19Features, seed: int) -> None:
    """flax's default conv init (LeCun truncated normal, zero bias) from a
    torch generator; the numbers differ from the JAX package's."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            t = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            m.weight.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
            nn.init.zeros_(m.bias)


def load_vgg19_params(path: Optional[str] = None, mode: str = "vgg19") -> Tuple[dict, bool]:
    """VGG19 weights as a ``state_dict`` for :class:`VGG19Features`, and
    whether they are pretrained.

    ``mode="vgg19"`` reads the ``.npz`` file (raises ``FileNotFoundError``
    without one: no silent quality loss); ``mode="random"`` is the explicit
    opt-in for a fixed random VGG19.
    """
    from ..convert import vgg19_state_dict

    if mode == "random":
        print(
            "[learned_hologram_gan_tpu_torch] NOTE: perceptual loss uses a FIXED "
            "RANDOM VGG19 (explicit perceptual='random'). Training quality is "
            "NOT comparable to the reference's pretrained-VGG objective; see "
            "docs/perceptual_fallback.md for the measured effect."
        )
        model = VGG19Features()
        _random_init(model, 0)
        return model.state_dict(), False
    if mode != "vgg19":
        raise ValueError(f"unknown perceptual mode {mode!r}")
    path = path or DEFAULT_WEIGHTS_PATH
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"perceptual='vgg19' needs pretrained weights, none at {path!r}. "
            "Generate them with tools/convert_vgg19.py on a machine with "
            "torchvision, or opt in to the untrained fallback explicitly "
            "with perceptual='random' (CLI: --perceptual random), or disable "
            "the term with perceptual='none'."
        )
    return vgg19_state_dict(vgg19_tree_from_npz(path)), True


def make_vgg19(state_dict: dict, device: str | torch.device = "cuda") -> VGG19Features:
    """A frozen :class:`VGG19Features` holding ``state_dict`` on ``device``."""
    model = VGG19Features()
    model.load_state_dict(state_dict)
    model.requires_grad_(False)
    return model.to(device).eval()


def perceptual_loss(vgg: VGG19Features, hat: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over taps of MSE(feat(hat), feat(target)), hat and target in one
    concatenated batch (reference :38-51)."""
    taps = vgg(torch.cat([hat, target], dim=0))
    b = hat.shape[0]
    loss = 0.0
    for t in taps:
        loss = loss + ((t[:b] - t[b:]) ** 2).mean()
    return loss / len(taps)
