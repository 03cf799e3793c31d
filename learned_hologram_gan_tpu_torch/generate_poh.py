#!/usr/bin/env python
"""Generate a phase-only hologram and optionally propagate a focal stack.

The port's counterpart of ``generatePOH.py``, with its flags, defaults and
messages: load an RGBD sample by index -> Generator forward -> save the POH
-> optionally propagate it with unit amplitude to ``--num_intervals``
distances and save the normalized stack as PNGs.  Runs on ``--device``
(``cuda`` unless asked otherwise)::

    python -m learned_hologram_gan_tpu_torch.generate_poh --img_path img.bin \\
        --depth_path depth.bin --index 0 --model_path G.pt \\
        --poh_output_path poh.npy --propagate --num_intervals 3 \\
        --output_image_dir recon

``--model_path`` names a torch ``state_dict`` of the port's Generator (for
example written from JAX weights with ``convert.generator_state_dict``).
Reading the JAX package's flax ``.msgpack`` files is not ported yet.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Script for generating and propagating POH"
    )
    parser.add_argument("--img_path", type=str, required=True, help="Path to the input img.bin file")
    parser.add_argument("--depth_path", type=str, required=True, help="Path to the input depth.bin file")
    parser.add_argument("--index", type=int, required=True, help="Index of the sample to generate POH for")
    parser.add_argument("--model_path", type=str, required=True, help="Path to the pretrained model")
    parser.add_argument("--poh_output_path", type=str, required=True, help="Path to save the generated POH")

    parser.add_argument("--samplesNum", type=int, default=100, help="Number of samples")
    parser.add_argument("--sample_row_num", type=int, default=384, help="Number of sample rows")
    parser.add_argument("--sample_col_num", type=int, default=384, help="Number of sample columns")
    parser.add_argument("--pad_size", type=int, default=320, help="Padding size")
    parser.add_argument("--pixel_pitch", type=float, default=3.74e-6, help="Pixel pitch")
    parser.add_argument("--wave_length", nargs="+", type=float,
                        default=[638e-9, 520e-9, 450e-9], help="Wavelengths for RGB channels")
    parser.add_argument("--distance", type=float, default=1e-3, help="Distance for propagation")
    parser.add_argument("--filter_radius_coefficient", type=float, default=0.35,
                        help="Filter radius coefficient")

    parser.add_argument("--propagate", action="store_true", help="Flag to enable propagation")
    parser.add_argument("--min_distance", type=float, default=4e-4, help="Minimum distance for propagation")
    parser.add_argument("--max_distance", type=float, default=10e-4, help="Maximum distance for propagation")
    parser.add_argument("--num_intervals", type=int, default=1, help="Number of intervals for propagation distances")
    parser.add_argument("--output_image_dir", type=str, default=None, help="Directory to save propagated images")

    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--unet_base_features", type=int, default=64,
                        help="UNet width multiplier (reference architecture = 64).")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="Shard the focal-stack distance axis over this many devices.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda unless asked otherwise)")
    return parser


def save_poh(poh_np: np.ndarray, path: str) -> None:
    """``.pt`` paths get a torch tensor, everything else numpy ``.npy``."""
    if path.endswith(".pt"):
        torch.save(torch.from_numpy(poh_np), path)
        return
    with open(path, "wb") as f:
        np.save(f, poh_np)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI on ``argv``; returns the POH, the focal stack (or None)
    and the written PNG paths."""
    from .config import GeneratorConfig, OpticsConfig
    from .data import ImgDepthDataset
    from .models import make_generator, make_generator_plan
    from .ops import asm
    from .train import build_infer_fn
    from .utils import tensor_normalizor_2d
    from .utils.plotting import multi_sample_plotter

    args = build_parser().parse_args(argv)
    if args.dtype != "float32":
        raise NotImplementedError("--dtype bfloat16 is not ported yet")
    if args.mesh_devices:
        raise NotImplementedError("--mesh_devices is not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")

    dataset_test = ImgDepthDataset(
        img_path=args.img_path,
        depth_path=args.depth_path,
        samples_num=args.samplesNum,
        channels_num=3,
        height=args.sample_row_num,
        width=args.sample_col_num,
    )

    gen_config = GeneratorConfig(
        rows=args.sample_row_num,
        cols=args.sample_col_num,
        pad_size=args.pad_size,
        filter_radius_coefficient=0.45,  # reference generatePOH.py:30
        pixel_pitch=args.pixel_pitch,
        wavelengths=tuple(args.wave_length),
        distance=args.distance,
        unet_base_features=args.unet_base_features,
    )
    generator = make_generator(gen_config, seed=0, device=device)
    gen_plan = make_generator_plan(gen_config, device=device)

    if args.model_path is not None and os.path.exists(args.model_path):
        if args.model_path.endswith(".msgpack"):
            raise NotImplementedError(
                "reading flax .msgpack checkpoints is not ported yet; convert "
                "them with learned_hologram_gan_tpu_torch.convert.generator_state_dict "
                "and save a torch state_dict"
            )
        state = torch.load(args.model_path, map_location=device, weights_only=True)
        generator.load_state_dict(state)
        print(f"Generator loaded from {args.model_path}")
    elif args.model_path is not None:
        print(f"WARNING: model path {args.model_path} not found; using random init")

    infer = build_infer_fn(generator)
    rgbd = torch.from_numpy(np.asarray(dataset_test[args.index])).to(device)[None]
    poh = infer(gen_plan, rgbd)

    save_poh(poh[0].cpu().numpy(), args.poh_output_path)
    print(f"POH data saved at {args.poh_output_path}")

    result = {"poh": poh, "focal_stack": None, "png_paths": []}
    if args.propagate:
        optics = OpticsConfig(
            rows=args.sample_row_num,
            cols=args.sample_col_num,
            pad_size=args.pad_size,
            filter_radius_coefficient=args.filter_radius_coefficient,
            pixel_pitch=args.pixel_pitch,
            wavelengths=tuple(args.wave_length),
        )
        distances = np.linspace(args.min_distance, args.max_distance, args.num_intervals)
        plan = asm.make_plan(optics, distances=distances, device=device)
        with torch.inference_mode():
            amp_hat = asm.propagate_batch_multi(plan, torch.ones_like(poh), poh)
            imgs = tensor_normalizor_2d(amp_hat).cpu().numpy()
        result["focal_stack"] = amp_hat
        result["png_paths"] = multi_sample_plotter(
            imgs, titles=None, save_dir=args.output_image_dir
        )
        print(f"Propagated images saved at {args.output_image_dir}")
    return result


if __name__ == "__main__":
    main()
