#!/usr/bin/env python
"""Convert the reference pipeline's (WeijieXie/learned_hologram_gan) torch
checkpoints to flax msgpack files (the port's counterpart of
``tools/convert_reference_weights.py``).

Maps a ``state_dict`` saved by the reference pipeline onto the flax
parameter tree and writes the same msgpack bytes as the JAX tool (through
``train/flax_msgpack.py``, without flax), which ``--pretrained_model_path_G/D``,
``--pretrained_part1/2`` and ``generate_poh --model_path`` read in both
packages.  :func:`convert` is the flax-tree step alone: its output goes
straight into the port's modules through ``convert.generator_state_dict``
/ ``discriminator_state_dict``, and the tool loads it so, strictly, on
``--device`` (``cuda`` unless asked otherwise) before it writes the file.

Checkpoint kinds (``--kind``):
  generator       reference Generator (generator.py:15): part1 RGBD2AP UNet +
                  part2 AP2POH symmetric convs
  rgbd2ap         stage 1 only (RGBD2AP.py:15)
  ap2poh          stage 2 only (AP2POH.py:16)
  discriminator   WGANGPDiscriminator192 (discriminator.py:5)

Usage::

    python -m learned_hologram_gan_tpu_torch.tools.convert_reference_weights \\
        --kind generator --in watermelon_GAN_GENERATOR.pth --out G.msgpack [--device cpu]

Key map (torch -> flax):
  UNet  encoder{i+1}.{0|1}.<ResidualBlock>   -> unet/enc_{i}/...
        bottleneck.1 / bottleneck.2 (ConvT)  -> unet/bottleneck, unet/ConvTranspose_0
        decoder{j}.0 / decoder{j}.1 (ConvT)  -> unet/dec_{4-j}, unet/ConvTranspose_{j}
        final_layer.0                        -> unet/Conv_0
  ResidualBlock convolution_layer_{1,2,3}    -> Conv_{0,1,2}
                batch_norm_layer_{1,2}       -> BatchNorm_{0,1} (+ batch_stats)
  AP2POH part1.conv_{r,g,b}.{params,bias}    -> modulation/conv_{r,g,b}/
                                                {radial_weights,bias}
  Critic block1.0, block{2..6}.{0,1}, conv   -> Conv_0..6 + BatchNorm_0..4

Conv kernels transpose OIHW -> HWIO; ConvTranspose IOHW -> HWIO.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

Tree = Dict[str, dict]


def _np(sd: Mapping, key: str) -> np.ndarray:
    return sd[key].detach().cpu().numpy()


def _conv(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": np.ascontiguousarray(_np(sd, prefix + ".weight").transpose(2, 3, 1, 0))}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd, prefix + ".bias")
    return out


def _conv_t(sd: Mapping, prefix: str) -> dict:
    # torch ConvTranspose2d weight: (in, out, kh, kw) -> flax (kh, kw, in, out)
    out = {"kernel": np.ascontiguousarray(_np(sd, prefix + ".weight").transpose(2, 3, 0, 1))}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd, prefix + ".bias")
    return out


def _bn(sd: Mapping, prefix: str) -> Tuple[dict, dict]:
    params = {"scale": _np(sd, prefix + ".weight"), "bias": _np(sd, prefix + ".bias")}
    stats = {"mean": _np(sd, prefix + ".running_mean"), "var": _np(sd, prefix + ".running_var")}
    return params, stats


def _residual_block(sd: Mapping, prefix: str) -> Tuple[dict, dict]:
    params, stats = {}, {}
    params["Conv_0"] = _conv(sd, prefix + ".convolution_layer_1")
    params["Conv_1"] = _conv(sd, prefix + ".convolution_layer_2")
    if prefix + ".convolution_layer_3.weight" in sd:
        params["Conv_2"] = _conv(sd, prefix + ".convolution_layer_3")
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn(sd, prefix + ".batch_norm_layer_1")
    params["BatchNorm_1"], stats["BatchNorm_1"] = _bn(sd, prefix + ".batch_norm_layer_2")
    return params, stats


def convert_unet(sd: Mapping, prefix: str = "part1.") -> Tuple[dict, dict]:
    """Reference UNet (neural_network_components.py:241-315) -> the UNet tree."""
    params, stats = {}, {}
    # encoder1 has no MaxPool in front; encoders 2..4 are Sequential(pool, block)
    for i in range(4):
        sub = f"{prefix}encoder{i + 1}.{0 if i == 0 else 1}.0"
        params[f"enc_{i}"], stats[f"enc_{i}"] = _residual_block(sd, sub)
    params["bottleneck"], stats["bottleneck"] = _residual_block(sd, prefix + "bottleneck.1.0")
    params["ConvTranspose_0"] = _conv_t(sd, prefix + "bottleneck.2")
    # reference decoder1..3 = Sequential(block, convT); decoder4 = block:
    # dec_3..dec_1 mirror decoder1..3, dec_0 mirrors decoder4
    for j in range(1, 4):
        ours = f"dec_{4 - j}"
        params[ours], stats[ours] = _residual_block(sd, f"{prefix}decoder{j}.0.0")
        params[f"ConvTranspose_{j}"] = _conv_t(sd, f"{prefix}decoder{j}.1")
    params["dec_0"], stats["dec_0"] = _residual_block(sd, prefix + "decoder4.0")
    params["Conv_0"] = _conv(sd, prefix + "final_layer.0")
    return params, stats


def convert_rgbd2ap(sd: Mapping, prefix: str = "") -> Tuple[dict, dict]:
    unet_p, unet_s = convert_unet(sd, prefix + "part1.")
    return {"unet": unet_p}, {"unet": unet_s}


def convert_ap2poh(sd: Mapping, prefix: str = "") -> Tuple[dict, dict]:
    params = {"modulation": {}}
    for c in ("r", "g", "b"):
        params["modulation"][f"conv_{c}"] = {
            "radial_weights": _np(sd, f"{prefix}part1.conv_{c}.params"),
            "bias": _np(sd, f"{prefix}part1.conv_{c}.bias"),
        }
    return params, {}


def convert_generator(sd: Mapping) -> Tuple[dict, dict]:
    p1, s1 = convert_rgbd2ap(sd, "part1.")
    p2, s2 = convert_ap2poh(sd, "part2.")
    return {"part1": p1, "part2": p2}, {"part1": s1, "part2": s2}


def convert_discriminator(sd: Mapping) -> Tuple[dict, dict]:
    """WGANGPDiscriminator192 (discriminator.py:5-51) -> the critic tree."""
    params, stats = {}, {}
    params["Conv_0"] = _conv(sd, "block1.0")
    for i in range(2, 7):  # block2..block6: Sequential(conv, bn, lrelu)
        params[f"Conv_{i - 1}"] = _conv(sd, f"block{i}.0")
        params[f"BatchNorm_{i - 2}"], stats[f"BatchNorm_{i - 2}"] = _bn(sd, f"block{i}.1")
    params["Conv_6"] = _conv(sd, "conv")
    return params, stats


CONVERTERS = {
    "generator": convert_generator,
    "rgbd2ap": convert_rgbd2ap,
    "ap2poh": convert_ap2poh,
    "discriminator": convert_discriminator,
}


def convert(kind: str, state_dict: Mapping) -> Tree:
    """A reference ``state_dict`` of ``kind`` -> the flax variables
    ``{"params", "batch_stats"}`` (nested dicts of numpy arrays), which
    ``convert.generator_state_dict`` (generator, rgbd2ap, ap2poh) or
    ``convert.discriminator_state_dict`` carries into the port's module."""
    params, stats = CONVERTERS[kind](state_dict)
    return {"params": params, "batch_stats": stats}


def check_loads(kind: str, variables: Tree, device: str = "cuda") -> None:
    """Load ``variables`` strictly into the port's module for ``kind`` on
    ``device``, sized from them (the UNet's base width, the critic's
    ``feature_d``): raises where a leaf has no counterpart or another
    shape."""
    import torch

    from .. import convert as convert_lib
    from ..config import GeneratorConfig
    from ..models import AP2POH, RGBD2AP, Generator, WGANGPDiscriminator192

    params = variables["params"]
    if kind == "discriminator":
        module = WGANGPDiscriminator192(feature_d=params["Conv_0"]["kernel"].shape[-1])
        state = convert_lib.discriminator_state_dict(variables)
    else:
        unet = (params["part1"] if kind == "generator" else params).get("unet")
        base = unet["enc_0"]["Conv_0"]["kernel"].shape[-1] if unet is not None else 64
        module = {"generator": lambda: Generator(GeneratorConfig(unet_base_features=base)),
                  "rgbd2ap": lambda: RGBD2AP(base_features=base),
                  "ap2poh": lambda: AP2POH(kernel_size=3)}[kind]()
        state = convert_lib.generator_state_dict(variables)
    module.to(torch.device(device)).load_state_dict(state)


def load_state_dict(path: str) -> Mapping:
    """A reference checkpoint file's ``state_dict`` (tensors only:
    ``weights_only``)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the tool on ``argv``; returns the path written and its size."""
    import torch

    from ..train import flax_msgpack

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=sorted(CONVERTERS), required=True)
    ap.add_argument("--in", dest="inp", required=True, help="reference .pth path")
    ap.add_argument("--out", required=True, help="output .msgpack path")
    ap.add_argument("--device", default="cuda",
                    help="device of the strict load into the port's module that checks the "
                         "conversion before the file is written (cuda unless asked otherwise)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")

    variables = convert(args.kind, load_state_dict(args.inp))
    check_loads(args.kind, variables, args.device)
    blob = flax_msgpack.to_bytes(variables)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob)} bytes)")
    return dict(path=args.out, bytes=len(blob))


if __name__ == "__main__":
    main()
