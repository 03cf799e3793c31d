#!/usr/bin/env python
"""Quantify the random-VGG perceptual term (docs/perceptual_fallback.md; the
port's counterpart of ``tools/perceptual_study.py``).

Pretrained VGG19 weights cannot be obtained offline, so the reference's
perceptual objective (loss_func.py:12-51) cannot be reproduced exactly.
This study bounds what the *random*-VGG stand-in (the explicit
``perceptual='random'`` opt-in) does to training: two otherwise identical
short runs, one with the random-VGG term at the reference weight (0.1), one
without the term, and the PSNR/SSIM/pixel-loss deltas between them.  The
configuration is the JAX tool's (32 x 32, pad 8, 8 planes, UNet base 8,
24 non-adversarial steps of batch 2 on seeded random data); ``--device``
picks the card (default) or the CPU::

    python -m learned_hologram_gan_tpu_torch.tools.perceptual_study --device cpu
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch


def run(perceptual: str, steps: int = 24, seed: int = 7, device: str = "cuda") -> dict:
    """One short non-adversarial run with the ``perceptual`` term; returns
    its history."""
    from ..train import Watermelon

    rng = np.random.default_rng(123)

    def tensor(shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)

    batches = [(tensor((2, 4, 32, 32)), tensor((2, 3, 32, 32)), tensor((2, 3, 32, 32))) for _ in range(steps)]
    trainer = Watermelon(
        filter_radius_coefficient=0.45,
        pad_size=8,
        distance_stack=np.linspace(-4e-4, 0.0, 9)[:-1],
        input_shape=(2, 4, 32, 32),
        use_gan=False,
        perceptual=perceptual,
        unet_base_features=8,
        feature_d=4,
        device=device,
    )
    return trainer.train(
        data_loader_train=lambda: iter(batches),
        data_loader_val=lambda: iter(batches[:2]),
        perceptual_loss_weight=1e-1,  # reference trainingModel.py:94
        epoch_num=1,
        info_print_interval=4,
        checkpoint_iterval=10,
        seed=seed,
    )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run both arms; returns (and prints) the JSON the JAX tool prints."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device to run on (cuda unless asked otherwise)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")

    results = {}
    for mode in ("none", "random"):
        hist = run(mode, device=args.device)
        results[mode] = {
            "final_PSNR": hist["train_metrics_tensor"]["PSNR"][-1],
            "final_SSIM": hist["train_metrics_tensor"]["SSIM"][-1],
            "final_pixel_loss": hist["train_losses_tensor"]["pixel_loss"][-1],
            "final_perceptual_loss": hist["train_losses_tensor"]["perceptual_loss"][-1],
            "PSNR_trajectory": hist["train_metrics_tensor"]["PSNR"],
        }
    delta = {k: results["random"][f"final_{k}"] - results["none"][f"final_{k}"]
             for k in ("PSNR", "SSIM", "pixel_loss")}
    out = {"runs": results, "random_minus_none": delta}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
