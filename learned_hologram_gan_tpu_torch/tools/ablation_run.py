#!/usr/bin/env python
"""Ablation-ordering study at the config of record (the port's counterpart
of ``tools/ablation_run.py``).

Trains the reference's ablation variants (reference watermelon.py:640-938)
for the same number of epochs from the same pretrained stage-1/stage-2
parts and the same seed, then evaluates each with the port's
``tools/eval_quality`` in this process.  The sanity check: the full
WGAN-GP objective and its ablations should order the way the reference
paper expects (dropping the modulation conv hurts; the non-GAN variant
differs mainly in texture sharpness, tracked by SSIM).  ``ordering.json``
aggregates every variant under ``--out`` that has an evaluation summary on
disk, not only those trained in this call.

The flags and defaults are the JAX tool's, plus ``--device`` (``cuda``
unless asked otherwise), except ``--out``: it defaults to
``output/ablations_torch``, so that the JAX-written ``output/ablations``
is never overwritten.  ``--parts`` keeps its default, the JAX-written
``output/quality_run``, which is only read::

    python -m learned_hologram_gan_tpu_torch.tools.ablation_run --parts output/quality_run --epochs 15
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import ImgDepthAmpPhsDataset, dataset_to_device, device_epoch_loader
from ..train import Watermelon
from ..utils import set_seed
from . import eval_quality

SEED = 122731
DEFAULT_OUT = "output/ablations_torch"

VARIANTS = {
    # name -> Watermelon constructor overrides (reference watermelon.py:640-938);
    # full_GAN: the complete WGAN-GP objective under the same matched-budget protocol
    "full_GAN": dict(),
    "without_GAN": dict(use_gan=False),
    "without_GAN_without_modulation": dict(use_gan=False, use_modulation=False),
    "without_GAN_and_plain_phase_loss": dict(use_gan=False, phase_loss="plain"),
    "without_GAN_without_perceptual_loss": dict(use_gan=False, perceptual="none"),
    "without_GAN_and_focal_sincos_phase_loss": dict(use_gan=False, phase_loss="focal_sincos"),
    "without_GAN_and_phase_sincos_gradient_loss": dict(use_gan=False, phase_loss="sincos_gradient"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default="data/synth384")
    ap.add_argument("--parts", default="output/quality_run",
                    help="dir holding rgbd2ap.msgpack / ap2poh.msgpack (read only)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--train_num", type=int, default=500)
    ap.add_argument("--val_num", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless asked otherwise)")
    return ap


def _metrics(path: str) -> dict:
    with open(path) as f:
        s = json.load(f)
    return {"val_PSNR": s["val_PSNR"], "val_SSIM": s["val_SSIM"]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the study on ``argv``; returns ``ordering`` (what
    ``ordering.json`` holds) and, for each variant trained in this call, its
    training and evaluation wall times and its history (``runs``)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")

    def paths(split):
        return dict(img_path=f"{args.data}/{split}/img.bin", depth_path=f"{args.data}/{split}/depth.bin",
                    amp_path=f"{args.data}/{split}/amp.bin", phs_path=f"{args.data}/{split}/phs.bin")

    common = dict(channels_num=3, height=args.rows, width=args.cols)
    ds_train = ImgDepthAmpPhsDataset(samples_num=args.train_num, **paths("train"), **common)
    ds_val = ImgDepthAmpPhsDataset(samples_num=args.val_num, **paths("val"), **common)
    dev_train = dataset_to_device(ds_train, device=device)
    dev_val = dataset_to_device(ds_val, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    part1 = os.path.join(args.parts, "rgbd2ap.msgpack")
    part2 = os.path.join(args.parts, "ap2poh.msgpack")
    summary, runs = {}, {}
    for name in args.variants:
        overrides = VARIANTS[name]
        out_dir = os.path.join(args.out, name)
        os.makedirs(out_dir, exist_ok=True)
        print(f"=== ablation {name}: {args.epochs} epochs ===", flush=True)
        set_seed(SEED)
        epoch_seed = [SEED]

        def loader_train():
            epoch_seed[0] += 1
            return device_epoch_loader(dev_train, args.batch_size, shuffle=True, drop_last=True,
                                       seed=epoch_seed[0])

        def loader_val():
            return device_epoch_loader(dev_val, max(args.batch_size // 2, 1), shuffle=False, drop_last=False)

        trainer_kw = dict(
            filter_radius_coefficient=0.45,
            pad_size=320,
            distance_stack=np.linspace(-4e-4, 0.0, 21)[:-1],
            input_shape=(args.batch_size, 4, args.rows, args.cols),
            perceptual="random",
            dtype=args.dtype,
            pretrained_part1_path=part1 if os.path.exists(part1) else None,
            pretrained_part2_path=part2 if os.path.exists(part2) else None,
        )
        trainer_kw.update(overrides)  # the variant wins (e.g. perceptual="none")
        trainer = Watermelon(**trainer_kw, device=device)
        t0 = time.time()
        history = trainer.train(
            data_loader_train=loader_train,
            data_loader_val=loader_val,
            phs_gradient_loss_weight=1,
            perceptual_loss_weight=1e-1,
            pixel_loss_weight=1,
            TV_loss_weight=1e-3,
            discriminator_loss_weight=1e-1,
            epoch_num=args.epochs,
            lr_G=1e-3,
            lr_D=1e-3,
            save_path_G=os.path.join(out_dir, "generator.msgpack"),
            save_path_D=None,
            # in-train validation is read-only; the study's datum is the
            # final evaluation over the full val set, so its cadence is off
            info_print_interval=100_000,
            info_plot_interval=10_000,
            loss_metrics_file=os.path.join(out_dir, "history.json"),
            save_path_img=None,
            checkpoint_iterval=10_000,  # final save only
            discriminator_train_ratio=5,
            discriminator_lambda=10,
            seed=SEED,
        )
        sync()
        train_s = time.time() - t0
        print(f"{name} trained in {train_s:.0f}s", flush=True)
        del trainer
        eval_argv = ["--data", args.data, "--run_dir", out_dir,
                     "--rows", str(args.rows), "--cols", str(args.cols),
                     "--val_num", str(args.val_num), "--dtype", args.dtype,
                     "--samples", "0"]
        if not overrides.get("use_modulation", True):
            eval_argv.append("--no_modulation")
        t0 = time.time()
        eval_quality.main(eval_argv + ["--device", args.device])
        sync()
        runs[name] = dict(train_s=train_s, eval_s=time.time() - t0, history=history)
        summary[name] = _metrics(os.path.join(out_dir, "eval", "summary.json"))
        print(json.dumps({name: summary[name]}), flush=True)

    # every variant with an evaluation summary on disk, not just the ones
    # trained in this call, so a partial run cannot shrink ordering.json
    for name in sorted(os.listdir(args.out)):
        path = os.path.join(args.out, name, "eval", "summary.json")
        if name not in summary and os.path.exists(path):
            summary[name] = _metrics(path)
    with open(os.path.join(args.out, "ordering.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return dict(ordering=summary, runs=runs)


if __name__ == "__main__":
    main()
