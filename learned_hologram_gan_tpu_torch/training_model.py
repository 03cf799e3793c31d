#!/usr/bin/env python
"""Train the hologram generator: the port's counterpart of ``trainingModel.py``.

The same flags, defaults and messages, plus ``--device`` (``cuda`` unless
asked otherwise).  As in the reference CLI the default trainer is the
non-adversarial variant; ``--use_gan`` runs the full WGAN-GP loop::

    python -m learned_hologram_gan_tpu_torch.training_model \\
        --train_img_path img.bin --train_depth_path depth.bin \\
        --train_amp_path amp.bin --train_phs_path phs.bin \\
        --validate_img_path vimg.bin --validate_depth_path vdepth.bin \\
        --validate_amp_path vamp.bin --validate_phs_path vphs.bin \\
        --samplesNum 12 --channlesNum 3 --height 384 --width 384 \\
        --save_path_G out/G.pt --save_path_D out/D.pt \\
        --loss_metrics_file out/history.json --save_path_img out/imgs \\
        --use_gan --perceptual random --epoch_num 1

Checkpoint paths ending in ``.msgpack`` (``--save_path_G/D``,
``--pretrained_G/D``, ``--pretrained_part1/2``) are flax files the JAX
package reads and writes; others are torch ``state_dict`` files.  The
fine-tune stage of the two-stage workflow takes the stage files that
``train/pretrain.py`` writes::

    ... --pretrained_part1 rgbd2ap.msgpack --pretrained_part2 ap2poh.msgpack \
        --freeze_part1 --resume_dir out/resume

``--resume_dir`` keeps full-state checkpoints there and resumes from the
latest on a restart.  The high-resolution levers run as in the JAX
package: ``--remat`` (recompute activations in the backward),
``--no_cache_h`` (no transfer-function stack kept) and
``--device_resident_data`` (both splits uploaded once, float32; batches
gathered on the device), and so does ``--polyphase_level0``.

Multi-device (``parallel/``; one process per card): ``--mesh_devices N``
trains data-parallel, each rank on its rows of every batch, and
``--spatial_mesh_devices N`` runs every propagation FFT as the row-sharded
pencil FFT over N ranks (both padded dims must divide by N).  Under
``torchrun --nproc_per_node N`` each process runs one rank; started
alone, the CLI starts its N ranks itself (NCCL on ``cuda:0..N-1``, gloo
with ``--device cpu``).  Only rank 0 prints and writes files.
``--device_resident_data`` with ``--mesh_devices`` is refused, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from typing import Optional, Sequence

import numpy as np

from .config import DEFAULT_SEED as SEED  # reference trainingModel.py:18


def check_and_create_folder(path):
    if path and not os.path.exists(path):
        print(f"Folder {path} does not exist, creating it...")
        os.makedirs(path)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a GAN model for hologram generation.")

    # required arguments (names identical to the reference CLI)
    parser.add_argument('--train_img_path', type=str, required=True, help="Path to training image binary file.")
    parser.add_argument('--train_depth_path', type=str, required=True, help="Path to training depth binary file.")
    parser.add_argument('--train_amp_path', type=str, required=True, help="Path to training amplitude binary file.")
    parser.add_argument('--train_phs_path', type=str, required=True, help="Path to training phase binary file.")

    parser.add_argument('--validate_img_path', type=str, required=True, help="Path to validation image binary file.")
    parser.add_argument('--validate_depth_path', type=str, required=True, help="Path to validation depth binary file.")
    parser.add_argument('--validate_amp_path', type=str, required=True, help="Path to validation amplitude binary file.")
    parser.add_argument('--validate_phs_path', type=str, required=True, help="Path to validation phase binary file.")

    parser.add_argument('--samplesNum', type=int, required=True, help="Number of samples in the dataset.")
    parser.add_argument('--channlesNum', type=int, required=True, help="Number of channels.")
    parser.add_argument('--height', type=int, required=True, help="Image height.")
    parser.add_argument('--width', type=int, required=True, help="Image width.")

    parser.add_argument('--batch_size', type=int, default=4, help="Batch size for training. Default is 4.")
    parser.add_argument('--lr_G', type=float, default=1e-3, help="Learning rate for generator. Default is 1e-3.")
    parser.add_argument('--lr_D', type=float, default=1e-3, help="Learning rate for discriminator. Default is 1e-3.")
    parser.add_argument('--epoch_num', type=int, default=50, help="Number of training epochs. Default is 50.")

    parser.add_argument('--save_path_G', type=str, required=True, help="Path to save the generator model.")
    parser.add_argument('--save_path_D', type=str, required=True, help="Path to save the discriminator model.")
    parser.add_argument('--loss_metrics_file', type=str, required=True, help="Path to save the loss metrics file.")
    parser.add_argument('--save_path_img', type=str, required=True, help="Path to save generated images.")

    parser.add_argument('--use_gan', action='store_true',
                        help="Train the full WGAN-GP variant (reference default is without GAN).")
    parser.add_argument('--perceptual', type=str, default='vgg19', choices=['vgg19', 'random', 'none'],
                        help="Perceptual loss backend. 'vgg19' needs converted weights "
                             "(tools/convert_vgg19.py); 'random' is the explicit "
                             "untrained-VGG opt-in; 'none' disables the term.")
    parser.add_argument('--perceptual_weights', type=str, default=None,
                        help="Path to VGG19 weights npz (see tools/convert_vgg19.py).")
    parser.add_argument('--dtype', type=str, default='float32', choices=['float32', 'bfloat16'],
                        help="Conv compute dtype; parameters stay float32.")
    parser.add_argument('--mesh_devices', type=int, default=0,
                        help="Data-parallel over this many devices, one process each (0 = single device).")
    parser.add_argument('--spatial_mesh_devices', type=int, default=0,
                        help="Spatially shard every propagation FFT over this many devices (pencil FFT; "
                             "the count must divide both padded dims). 0 = off.")
    parser.add_argument('--unet_base_features', type=int, default=64,
                        help="UNet width multiplier (reference architecture = 64).")
    parser.add_argument('--pretrained_G', type=str, default=None,
                        help="Whole-generator pretrained weights, flax .msgpack or torch state_dict "
                             "(reference watermelon.py:84-90).")
    parser.add_argument('--pretrained_D', type=str, default=None,
                        help="Discriminator pretrained weights (.msgpack or state_dict).")
    parser.add_argument('--pretrained_part1', type=str, default=None,
                        help="Stage-1 (RGBD2AP) pretrained weights, as train/pretrain.py writes them.")
    parser.add_argument('--pretrained_part2', type=str, default=None,
                        help="Stage-2 (AP2POH) pretrained weights, as train/pretrain.py writes them.")
    parser.add_argument('--freeze_part1', action='store_true',
                        help="Freeze the stage-1 parameters during fine-tuning.")
    parser.add_argument('--resume_dir', type=str, default=None,
                        help="Directory for full-train-state checkpoints; a restart resumes from "
                             "the latest.")
    parser.add_argument('--critic_batching', type=str, default='pair', choices=['separate', 'pair', 'full'],
                        help="WGAN-GP critic apply structure per iteration: 'separate' (real, fake and "
                             "penalty applies), 'pair' (one apply on [real; fake]) or 'full' (one apply on "
                             "[real; fake; interpolates]).")
    parser.add_argument('--two_h_hat', action='store_true',
                        help="Fold the fixed and focal transfer functions of the hat branch into one "
                             "(no spectrum built; O(1e-3) off the composed path).")
    parser.add_argument('--polyphase_level0', action='store_true',
                        help="Compute UNet level 0 in the space-to-depth phase domain (exact, same "
                             "checkpoint tree).")
    parser.add_argument('--device_resident_data', action='store_true',
                        help="Upload both splits to device memory once; batches are gathered there.")
    parser.add_argument('--remat', action='store_true',
                        help="Recompute activations in the backward (UNet blocks, reconstruction, "
                             "critic, VGG19) instead of keeping them.")
    parser.add_argument('--no_cache_h', action='store_true',
                        help="Compute the ASM transfer functions where they are used instead of "
                             "keeping their stack.")
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device to run on (cuda unless asked otherwise)")
    return parser


def _rank_entry(rank: int, world_size: int, argv: Sequence[str]):
    """One rank of a run the CLI started itself: its history on rank 0."""
    _, history = main(argv)
    return history if rank == 0 else None


def start_mesh(argv: Optional[Sequence[str]], n: int, device, entry):
    """The mesh of ``n`` ranks this process belongs to, on this rank's
    device, or None after running ``entry(rank, n, argv)`` on ``n`` ranks
    started here (no process group and no launcher's environment); then
    the ranks' results are in the second value."""
    import torch.distributed as dist

    from .parallel import launch
    from .parallel import mesh as mesh_lib

    if not dist.is_initialized() and not mesh_lib.initialize_distributed(device=device):
        argv = list(sys.argv[1:] if argv is None else argv)
        threads = 1 if device.type == "cpu" else None
        return None, launch.spawn(entry, n, (argv,), device=device, timeout_s=1800.0, threads=threads)
    return mesh_lib.make_mesh(n), None


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI on ``argv``; returns the trainer (its ``state``, steps
    and plans stay usable) and the history.  Under a mesh that the CLI
    started itself, the trainer lives in the ranks' processes: returns
    None and rank 0's history."""
    import torch

    from .data import ImgDepthAmpPhsDataset, dataset_to_device, device_epoch_loader, epoch_loader
    from .parallel import batch_sharding
    from .parallel import mesh as mesh_lib
    from .train import Watermelon

    args = build_parser().parse_args(argv)
    if args.mesh_devices and args.spatial_mesh_devices:
        raise ValueError("--mesh_devices and --spatial_mesh_devices lay out the same ranks two ways; "
                         "pass one")
    if args.mesh_devices and args.device_resident_data:
        raise SystemExit(
            "--device_resident_data with --mesh_devices is not supported "
            "yet: resident arrays would need per-device sharding. Use "
            "the streaming loader under a mesh."
        )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")
    mesh = None
    if args.mesh_devices or args.spatial_mesh_devices:
        mesh, ranks = start_mesh(argv, args.mesh_devices or args.spatial_mesh_devices, device,
                                 _rank_entry)
        if mesh is None:
            return None, ranks[0]
        device = mesh_lib.local_device(device)
    sharding = batch_sharding(mesh) if args.mesh_devices else None

    dataset_train = ImgDepthAmpPhsDataset(
        img_path=args.train_img_path,
        depth_path=args.train_depth_path,
        amp_path=args.train_amp_path,
        phs_path=args.train_phs_path,
        samples_num=args.samplesNum,
        channels_num=args.channlesNum,
        height=args.height,
        width=args.width,
    )
    dataset_validate = ImgDepthAmpPhsDataset(
        img_path=args.validate_img_path,
        depth_path=args.validate_depth_path,
        amp_path=args.validate_amp_path,
        phs_path=args.validate_phs_path,
        samples_num=100,  # reference trainingModel.py:46
        channels_num=args.channlesNum,
        height=args.height,
        width=args.width,
    )

    if args.device_resident_data:
        # both splits uploaded once; a batch is a gather on the device
        train_data = dataset_to_device(dataset_train, device=device)
        val_data = dataset_to_device(dataset_validate, device=device)
        loader = device_epoch_loader
    else:
        train_data, val_data = dataset_train, dataset_validate
        loader = functools.partial(epoch_loader, device=device, sharding=sharding)
    epoch_seed = [SEED]

    def loader_train():
        epoch_seed[0] += 1
        return loader(train_data, args.batch_size, shuffle=True, drop_last=True, seed=epoch_seed[0])

    def loader_val():
        return loader(val_data, max(args.batch_size // 2, 1), shuffle=False, drop_last=False)

    trainer = Watermelon(
        filter_radius_coefficient=0.45,              # reference :60
        pad_size=320,                                # reference :61
        distance_stack=np.linspace(-4e-4, 0.0, 21)[:-1],  # reference :62
        pretrained_model_path_G=args.pretrained_G,
        pretrained_model_path_D=args.pretrained_D,
        pretrained_part1_path=args.pretrained_part1,
        pretrained_part2_path=args.pretrained_part2,
        freeze_part1=args.freeze_part1,
        input_shape=(1, 4, args.height, args.width),
        use_gan=args.use_gan,
        perceptual=args.perceptual,
        perceptual_weights_path=args.perceptual_weights,
        dtype=args.dtype,
        unet_base_features=args.unet_base_features,
        remat=args.remat,
        cache_h=not args.no_cache_h,
        spatial_mesh=mesh if args.spatial_mesh_devices else None,
        data_mesh=mesh if args.mesh_devices else None,
        critic_batching=args.critic_batching,
        two_h_hat=args.two_h_hat,
        polyphase_level0=args.polyphase_level0,
        device=device,
    )

    if trainer.is_main:  # the rank that writes the files
        check_and_create_folder(os.path.dirname(args.save_path_G))
        check_and_create_folder(os.path.dirname(args.save_path_D))
        check_and_create_folder(os.path.dirname(args.loss_metrics_file))
        check_and_create_folder(args.save_path_img)

    history = trainer.train(
        data_loader_train=loader_train,
        data_loader_val=loader_val,
        phs_gradient_loss_weight=1,                  # reference :76-97 weights
        perceptual_loss_weight=1e-1,
        pixel_loss_weight=1,
        TV_loss_weight=1e-3,
        discriminator_loss_weight=1e-1,
        epoch_num=args.epoch_num,
        lr_G=args.lr_G,
        lr_D=args.lr_D,
        save_path_G=args.save_path_G,
        save_path_D=args.save_path_D,
        info_print_interval=50,
        info_plot_interval=50,
        loss_metrics_file=args.loss_metrics_file,
        save_path_img=args.save_path_img,
        checkpoint_iterval=1,
        discriminator_train_ratio=5,
        discriminator_lambda=10,
        step_scheduler_G_gamma=0.9999,
        step_scheduler_D_gamma=0.9999,
        visualization_RGBD_AP=dataset_validate[0],
        seed=SEED,
        resume_dir=args.resume_dir,
    )
    return trainer, history


if __name__ == "__main__":
    main()
