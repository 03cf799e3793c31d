#!/usr/bin/env python
"""Quality and speed of the int8-quantized generator against the fused path
(the port's counterpart of ``tools/eval_quant.py``).

The full-val focal-stack PSNR/SSIM sweep of ``tools/eval_quality.py`` three
times, with stage 1 through the fused path (``generator_apply_fused`` in
``--dtype``, the label ``bf16`` as in the JAX tool), through the dynamic
int8 UNet (``int8``) and through the full-integer one (``int8_static``),
both calibrated on ``--calib_num`` train samples; then, unless
``--time_batch 0``, the ``bench.py`` pipeline (batch 16, 3 planes) each way,
timed after two warm-ups over 10 batches ended by a host fetch::

    python -m learned_hologram_gan_tpu_torch.tools.eval_quant \\
        --data data/synth384 --run_dir output/quality_run

Writes ``<run_dir>/eval_quant/summary.json`` (or ``--out``).  Runs on the
CUDA device, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default="data/synth384")
    ap.add_argument("--run_dir", default="output/quality_run")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--pad_size", type=int, default=320)
    ap.add_argument("--filter_radius_coefficient", type=float, default=0.45)
    ap.add_argument("--val_num", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--calib_num", type=int, default=8,
                    help="train samples for activation-scale calibration")
    ap.add_argument("--num_planes", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--unet_base_features", type=int, default=64)
    ap.add_argument("--time_batch", type=int, default=16,
                    help="bench.py-config timing batch (0 = skip timing)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the tool on ``argv``; returns the summary it writes."""
    from ..data import ImgDepthAmpPhsDataset
    from ..losses import psnr, ssim
    from ..models import generator_apply_fused, generator_apply_quant
    from ..nn.quant import quantize_unet, quantize_unet_q8, quantized_bytes
    from ..ops import asm
    from ..train import Watermelon

    args = build_parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run on the CPU")
    out_dir = args.out or os.path.join(args.run_dir, "eval_quant")
    os.makedirs(out_dir, exist_ok=True)
    h, w = args.rows, args.cols

    def dataset(split, n):
        return ImgDepthAmpPhsDataset(
            *(os.path.join(args.data, split, f"{k}.bin") for k in ("img", "depth", "amp", "phs")),
            samples_num=n, height=h, width=w,
        )

    val = dataset("val", args.val_num)
    g_path = next(p for p in (os.path.join(args.run_dir, n) for n in ("G.msgpack", "generator.msgpack"))
                  if os.path.exists(p))
    trainer = Watermelon(
        filter_radius_coefficient=args.filter_radius_coefficient,
        pad_size=args.pad_size,
        distance_stack=np.linspace(-4e-4, 0.0, args.num_planes + 1)[:-1],
        pretrained_model_path_G=g_path,
        input_shape=(args.batch, 4, h, w),
        use_gan=False, perceptual="none", dtype=args.dtype,
        unet_base_features=args.unet_base_features, device=device,
    )
    trainer._init_state(seed=0, lr_G=1e-3, lr_D=1e-3)
    generator = trainer.state.generator.eval()
    unet = generator.part1.unet

    # ---- calibrate the int8 stage 1 on a few TRAIN samples ----
    calib_ds = dataset("train", args.calib_num)
    calib = np.stack([calib_ds.get(i)[0] for i in range(args.calib_num)])
    calib_nhwc = torch.from_numpy(np.ascontiguousarray(calib, np.float32)).to(device).permute(0, 2, 3, 1)
    qtrees = {"int8": quantize_unet(unet, calib_nhwc), "int8_static": quantize_unet_q8(unet, calib_nhwc)}
    q_mb = quantized_bytes(qtrees["int8"]) / 1e6
    f_mb = sum(p.numel() * 4 for p in unet.parameters()) / 1e6
    print(f"stage-1 params: {f_mb:.1f} MB f32 -> {q_mb:.1f} MB int8-packed", flush=True)

    def poh_fn(label):
        if label == "bf16":
            return lambda plan, rgbd: generator_apply_fused(generator, plan, rgbd)
        return lambda plan, rgbd: generator_apply_quant(generator, qtrees[label], plan, rgbd)

    gen_plan, multi_plan = trainer.gen_plan, trainer.multi_plan
    num_d = multi_plan.num_distances
    labels = ("bf16", "int8", "int8_static")

    # ---- the eval_quality reconstruction, parameterized by the POH fn ----
    @torch.inference_mode()
    def recon_all(fn, rgbd, amp, phs):
        rgbd, amp, phs = (torch.from_numpy(np.array(x, np.float32)).to(device) for x in (rgbd, amp, phs))
        poh = fn(gen_plan, rgbd)
        hat_freq = asm.propagate_poh2freq_forward(gen_plan, poh)
        tgt_freq = asm.filter_ap2filtered_freq(multi_plan, amp, phs)
        amps, _ = asm.freq2ap_all_distances(multi_plan, torch.cat([hat_freq, tgt_freq], dim=0))
        b = rgbd.shape[0]
        amps = amps.reshape(2 * b, num_d, *amps.shape[1:])
        return amps[:b], amps[b:]

    # SSIM's moment stack: chunk the plane axis at ~0.4 GB (eval_quality's rule)
    ssim_chunk = max(1, int(4e8 / (5 * 4 * h * w)))
    results = {}
    for label in labels:
        fn = poh_fn(label)
        tot_psnr = tot_ssim = 0.0
        n_batches = 0
        for start in range(0, args.val_num, args.batch):
            idx = range(start, min(start + args.batch, args.val_num))
            rgbd, amp, phs = (np.stack(x) for x in zip(*[val.get(i) for i in idx]))
            hat, tgt = recon_all(fn, rgbd, amp, phs)
            with torch.inference_mode():
                tot_psnr += float(psnr(hat, tgt))
                tot_ssim += float(ssim(hat.reshape(-1, *hat.shape[2:]), tgt.reshape(-1, *tgt.shape[2:]),
                                       plane_chunk=ssim_chunk))
            n_batches += 1
            print(f"[{label}] metrics {start + len(idx)}/{args.val_num}", flush=True)
        results[label] = {"val_PSNR": tot_psnr / n_batches, "val_SSIM": tot_ssim / n_batches}
        print(json.dumps({label: results[label]}), flush=True)

    # ---- bench.py-pipeline timing (generator + 3-plane recon), each path ----
    if args.time_batch:
        recon_plan = asm.make_plan(trainer.gen_config.optics(), distances=np.linspace(4e-4, 10e-4, 3),
                                   device=device)
        rgbd16 = torch.from_numpy(np.stack([val.get(i % args.val_num)[0] for i in range(args.time_batch)]
                                           ).astype(np.float32)).to(device)

        @torch.inference_mode()
        def pipe(fn):
            poh = fn(gen_plan, rgbd16)
            return asm.propagate_batch_multi(recon_plan, torch.ones_like(poh), poh)

        def fetch(out):  # a device-to-host round trip ends the timing
            return float(out[:, :, ::8, ::8].sum())

        for label in labels:
            fn = poh_fn(label)
            fetch(pipe(fn))
            fetch(pipe(fn))
            reps = 10
            t0 = time.perf_counter()
            for _ in range(reps):
                out = pipe(fn)
            fetch(out)
            dt = (time.perf_counter() - t0) / reps
            results[label]["poh_per_sec"] = args.time_batch / dt
            print(f"[{label}] {dt * 1e3:.1f} ms/batch-{args.time_batch} = "
                  f"{args.time_batch / dt:.1f} POH/s on {device}", flush=True)

    results["stage1_MB"] = {"f32": f_mb, "int8_packed": q_mb}
    results["delta_dB"] = {k: results[k]["val_PSNR"] - results["bf16"]["val_PSNR"]
                           for k in ("int8", "int8_static")}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
