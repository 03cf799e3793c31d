#!/usr/bin/env python
"""High-resolution fine-tune: carry a 384^2-trained generator to 1080p (the
port's counterpart of ``tools/finetune_highres.py``).

The generator is fully convolutional, so weights trained at 384^2 apply at
any resolution; only the propagator plans are resolution-bound.  The tool:

  1. loads the generator to start from (``--init``, a flax ``.msgpack`` or
     a torch state_dict; '' starts from the seeded random init);
  2. fine-tunes it at 1088 x 1920, pad 320, with the non-GAN objective
     (pixel + focal sin-cos phase gradient + TV; the reference's
     "without_GAN" ablation) under the single-card high-resolution levers:
     device-resident bfloat16 data, per-block UNet recomputation
     (``remat``), no transfer-function stack (``cache_h=False``), bfloat16
     convolutions;
  3. evaluates the result with the port's ``eval_quality`` at the same
     resolution, in this process.

The flags and defaults are the JAX tool's, plus ``--device`` (``cuda``
unless asked otherwise)::

    python -m learned_hologram_gan_tpu_torch.tools.finetune_highres \\
        --data data/synth1080 --init output/quality_run/generator.msgpack
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from typing import Optional, Sequence

import numpy as np

SEED = 122731


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default="data/synth1080")
    ap.add_argument("--out", default="output/finetune_1080p")
    ap.add_argument("--init", default="output/quality_run/generator.msgpack",
                    help="384^2-trained generator to start from ('' = random)")
    ap.add_argument("--rows", type=int, default=1088)
    ap.add_argument("--cols", type=int, default=1920)
    ap.add_argument("--pad_size", type=int, default=320)
    ap.add_argument("--train_num", type=int, default=48)
    ap.add_argument("--val_num", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--distances", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4,
                    help="fine-tune LR (lower than the 1e-3 from-scratch LR)")
    ap.add_argument("--eval_planes", type=int, default=8)
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--unet_base_features", type=int, default=64,
                    help="reduce for CPU smoke tests")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--data_dtype", default="bfloat16",
                    help="device-resident dataset storage dtype; bfloat16 "
                         "halves the footprint (48 train samples at 1080p "
                         "are 4.0 GB in float32)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless asked otherwise)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the tool on ``argv``; returns the training history, the wall
    times of the fine-tune (validation and saves included) and of the
    evaluation, each train step's seconds (``step_s``) and the
    evaluation's result (:func:`eval_quality.main`; None with
    ``--skip_eval``)."""
    import torch

    from ..data import ImgDepthAmpPhsDataset, dataset_to_device, device_epoch_loader
    from ..train import Watermelon
    from . import eval_quality

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")
    os.makedirs(args.out, exist_ok=True)
    # the host RNGs, as the JAX tool's set_seed pins them
    np.random.seed(SEED)
    random.seed(SEED)

    def paths(split):
        return dict(img_path=f"{args.data}/{split}/img.bin", depth_path=f"{args.data}/{split}/depth.bin",
                    amp_path=f"{args.data}/{split}/amp.bin", phs_path=f"{args.data}/{split}/phs.bin")

    common = dict(channels_num=3, height=args.rows, width=args.cols)
    ds_train = ImgDepthAmpPhsDataset(samples_num=args.train_num, **paths("train"), **common)
    ds_val = ImgDepthAmpPhsDataset(samples_num=args.val_num, **paths("val"), **common)
    data_dtype = torch.bfloat16 if args.data_dtype == "bfloat16" else None
    dev_train = dataset_to_device(ds_train, dtype=data_dtype, device=device)
    dev_val = dataset_to_device(ds_val, dtype=data_dtype, device=device)

    epoch_seed = [SEED]
    step_s = []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def loader_train():
        # the time from handing a batch out to being asked for the next,
        # the device synchronized at both ends, is that batch's train step
        # (with the validation of an info interval's last step)
        epoch_seed[0] += 1
        for batch in device_epoch_loader(dev_train, args.batch_size, shuffle=True, drop_last=True,
                                         seed=epoch_seed[0]):
            sync()
            t = time.perf_counter()
            yield batch
            sync()
            step_s.append(time.perf_counter() - t)

    def loader_val():
        return device_epoch_loader(dev_val, args.batch_size, shuffle=False, drop_last=False)

    trainer = Watermelon(
        filter_radius_coefficient=0.45,
        pad_size=args.pad_size,
        distance_stack=np.linspace(-4e-4, 0.0, args.distances + 1)[:-1],
        pretrained_model_path_G=args.init or None,
        input_shape=(args.batch_size, 4, args.rows, args.cols),
        use_gan=False,
        perceptual="none",
        dtype=args.dtype,
        unet_base_features=args.unet_base_features,
        remat=True,
        cache_h=False,
        device=device,
    )
    t0 = time.time()
    history = trainer.train(
        data_loader_train=loader_train,
        data_loader_val=loader_val,
        phs_gradient_loss_weight=1,
        perceptual_loss_weight=0.0,
        pixel_loss_weight=1,
        TV_loss_weight=1e-3,
        discriminator_loss_weight=0.0,
        epoch_num=args.epochs,
        lr_G=args.lr,
        lr_D=args.lr,
        save_path_G=os.path.join(args.out, "generator.msgpack"),
        save_path_D=None,
        info_print_interval=24,
        info_plot_interval=10_000,
        loss_metrics_file=os.path.join(args.out, "history.json"),
        save_path_img=None,
        checkpoint_iterval=10_000,
        discriminator_train_ratio=1,
        discriminator_lambda=10,
        seed=SEED,
    )
    sync()
    wall = time.time() - t0
    print(f"1080p fine-tune: {args.epochs} epochs in {wall:.0f}s", flush=True)
    print(f"train steps: first {step_s[0]:.3f} s" + (
        f", then {(len(step_s) - 1) / sum(step_s[1:]):.3f} steps/s over {len(step_s) - 1}"
        if len(step_s) > 1 else ""), flush=True)
    with open(os.path.join(args.out, "timings.json"), "w") as f:
        json.dump({"finetune_s": wall, "epochs": args.epochs, "init": args.init, "step_s": step_s}, f,
                  indent=1)
    del trainer, dev_train, dev_val

    evaluation, eval_s = None, None
    if not args.skip_eval:
        t0 = time.time()
        evaluation = eval_quality.main([
            "--data", args.data, "--run_dir", args.out,
            "--rows", str(args.rows), "--cols", str(args.cols),
            "--pad_size", str(args.pad_size),
            "--val_num", str(args.val_num), "--batch", "1",
            "--dtype", args.dtype, "--num_planes", str(args.eval_planes),
            "--no_cache_h", "--samples", "0",
            "--unet_base_features", str(args.unet_base_features),
            "--device", args.device,
        ])
        eval_s = time.time() - t0
    return dict(history=history, finetune_s=wall, step_s=step_s, eval_s=eval_s, evaluation=evaluation)


if __name__ == "__main__":
    main()
