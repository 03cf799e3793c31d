#!/usr/bin/env python
"""End-to-end quickstart on synthetic data (no dataset download needed), the
port's counterpart of ``examples/quickstart.py``.

Exercises the library the way the reference's README walkthrough does: build
the trainer, train a few non-adversarial steps at toy size, checkpoint,
reload, generate a POH, and propagate a focal stack to PNGs::

    python -m learned_hologram_gan_tpu_torch.examples.quickstart [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def main(out_dir: str = "output/quickstart", device: str = "cuda", unet_base_features: int = 8) -> dict:
    """Train, checkpoint, reload, generate and propagate; returns the
    history, the POH and the written PNG paths."""
    from ..ops import asm
    from ..train import Watermelon
    from ..utils import tensor_normalizor_2d
    from ..utils.plotting import multi_sample_plotter

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    def tensor(shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)

    def batches(n):
        # (RGBD, target amp, target phase in [0, 1])
        return [(tensor((2, 4, 32, 32)), tensor((2, 3, 32, 32)), tensor((2, 3, 32, 32)))
                for _ in range(n)]

    common = dict(filter_radius_coefficient=0.45, pad_size=16,
                  distance_stack=np.linspace(-4e-4, 0.0, 9)[:-1],
                  use_gan=False,            # reference CLI default (watermelon_without_GAN)
                  perceptual="none",        # "vgg19" once its weights are converted
                  unet_base_features=unet_base_features,  # the reference architecture is 64
                  device=device)
    trainer = Watermelon(input_shape=(2, 4, 32, 32), **common)
    history = trainer.train(
        data_loader_train=lambda: iter(batches(4)),
        data_loader_val=lambda: iter(batches(1)),
        epoch_num=2,
        info_print_interval=2,
        checkpoint_iterval=1,
        save_path_G=os.path.join(out_dir, "G.msgpack"),
        save_path_D=None,
        loss_metrics_file=os.path.join(out_dir, "history.json"),
    )
    print("final G loss:", history["train_losses_tensor"]["G_loss"][-1])

    # reload the checkpoint, then inference and focal-stack propagation
    trainer2 = Watermelon(input_shape=(1, 4, 32, 32),
                          pretrained_model_path_G=os.path.join(out_dir, "G.msgpack"), **common)
    poh = trainer2.generate(tensor((1, 4, 32, 32)))
    print("POH:", tuple(poh.shape))

    plan = asm.make_plan(trainer2.gen_config.optics(), distances=np.linspace(4e-4, 1e-3, 4),
                         device=device)
    with torch.inference_mode():
        recon = asm.propagate_batch_multi(plan, torch.ones_like(poh), poh)
    paths = multi_sample_plotter(tensor_normalizor_2d(recon).cpu().numpy(), save_dir=out_dir)
    print("focal stack PNGs:", paths)
    return dict(history=history, poh=poh, png_paths=paths)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", default="output/quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out_dir, args.device)
