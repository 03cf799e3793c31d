#!/usr/bin/env python
"""Post-training quality evaluation: focal-stack evidence and a metric
summary (the port's counterpart of ``tools/eval_quality.py``).

Writes, under ``--out`` (default ``<run_dir>/eval``):

  summary.json                  val-set PSNR/SSIM over the full focal stack
                                and the per-plane PSNR (the JAX tool's keys)
  sample{k}_focalstack.png      a grid: input RGB | target-field recon at
                                the far / middle / near planes (top row),
                                input depth | trained-POH recon at the same
                                planes (bottom row), through
                                ``utils/plotting.write_png``
  curves_psnr.png / curves_losses.png
                                the training trajectories (history.json),
                                drawn only where matplotlib imports

The reconstruction is the training step's (reference watermelon.py:216-234):
POH -> forward ASM to the image plane -> filtered spectrum -> each stack
distance; the target field takes the filter_AP2filteredFreq path.  So
PSNR/SSIM grade what the trainer optimized.  The flags and defaults are
the JAX tool's, plus ``--device`` (``cuda`` unless asked otherwise)::

    python -m learned_hologram_gan_tpu_torch.tools.eval_quality \\
        --data data/synth384 --run_dir output/quality_run

4K zero-shot (a 5-smooth column pad from ``utils/fftlen.good_fft_pads``,
one padded plane set in flight, no transfer-function stack)::

    python -m learned_hologram_gan_tpu_torch.tools.eval_quality \\
        --data data/synth4k --run_dir R --rows 2176 --cols 3840 \\
        --pad_size 352 --pad_cols 580 --sequential --no_cache_h \\
        --num_planes 8 --batch 1
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

# the run directory's generator, in the JAX tool's order, then the port's
# own state_dict file
WEIGHT_NAMES = ("G.msgpack", "generator.msgpack", "G.pt")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default="data/synth384")
    ap.add_argument("--run_dir", required=True,
                    help="training output dir containing G.msgpack + history.json")
    ap.add_argument("--out", default=None, help="default: <run_dir>/eval")
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--pad_size", type=int, default=320)
    ap.add_argument("--filter_radius_coefficient", type=float, default=0.45)
    ap.add_argument("--val_num", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--samples", type=int, nargs="*", default=[0, 1, 2],
                    help="val indices for the focal-stack grids")
    ap.add_argument("--no_modulation", action="store_true",
                    help="checkpoint was trained with use_modulation=False "
                         "(ablation: no part2 subtree in the saved state)")
    ap.add_argument("--num_planes", type=int, default=20,
                    help="focal-stack planes over [-4e-4, 0) for the metrics")
    ap.add_argument("--pad_cols", type=int, default=None,
                    help="column-pad override (4K: use utils/fftlen."
                         "good_fft_pads to avoid Bluestein-hostile lengths)")
    ap.add_argument("--sequential", action="store_true",
                    help="reconstruct one distance at a time "
                         "(4K: one padded plane set in flight instead of D)")
    ap.add_argument("--no_cache_h", action="store_true",
                    help="compute transfer functions where they are used (high-res: "
                         "a 20-plane cached H stack at 1080p is ~2 GB)")
    ap.add_argument("--unet_base_features", type=int, default=64,
                    help="must match the trained checkpoint (CPU smoke: 2-8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless asked otherwise)")
    return ap


def _grid_png(path: str, rgbd: np.ndarray, tgt: np.ndarray, hat: np.ndarray,
              planes: Sequence[int]) -> None:
    """The focal-stack grid of one sample: (4, H, W) RGBD, (D, 3, H, W)
    target and POH reconstructions, both scaled by the target's maximum."""
    from ..utils.plotting import write_png

    scale = max(float(tgt.max()), 1e-6)
    depth = np.repeat(np.clip(rgbd[3:4], 0, 1), 3, axis=0)
    top = [np.clip(rgbd[:3], 0, 1)] + [np.clip(tgt[d] / scale, 0, 1) for d in planes]
    bottom = [depth] + [np.clip(hat[d] / scale, 0, 1) for d in planes]
    grid = np.concatenate([np.concatenate(top, axis=-1), np.concatenate(bottom, axis=-1)], axis=-2)
    write_png(path, (np.transpose(grid, (1, 2, 0)) * 255).astype(np.uint8))


def _curves(run_dir: str, out_dir: str) -> None:
    hist_path = os.path.join(run_dir, "history.json")
    if not os.path.exists(hist_path):
        alt = os.path.join(run_dir, "resume", "history.json")
        hist_path = alt if os.path.exists(alt) else hist_path
    if not os.path.exists(hist_path):
        return
    from ..utils.plotting import training_process_visualizer

    try:
        training_process_visualizer(
            [hist_path],
            ["validate_metrics_tensor/PSNR", "train_metrics_tensor/PSNR"],
            os.path.join(out_dir, "curves_psnr.png"),
            labels=["run"],
        )
        training_process_visualizer(
            [hist_path],
            ["validate_losses_tensor/G_loss", "validate_losses_tensor/pixel_loss",
             "validate_losses_tensor/focal_phase_gradient_loss"],
            os.path.join(out_dir, "curves_losses.png"),
            labels=["run"],
        )
    except ImportError:
        print("matplotlib is not installed: curves_psnr.png and curves_losses.png skipped")
        return
    print("saved curves")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the tool on ``argv``; returns the summary it writes
    (``summary``) and the wall time of the metric sweep over the
    validation samples (``sweep_s``, the device synchronized)."""
    import torch

    from ..data import ImgDepthAmpPhsDataset
    from ..losses import psnr, ssim
    from ..ops import asm
    from ..train import Watermelon

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")
    out_dir = args.out or os.path.join(args.run_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)

    h, w = args.rows, args.cols
    val = ImgDepthAmpPhsDataset(
        img_path=os.path.join(args.data, "val", "img.bin"),
        depth_path=os.path.join(args.data, "val", "depth.bin"),
        amp_path=os.path.join(args.data, "val", "amp.bin"),
        phs_path=os.path.join(args.data, "val", "phs.bin"),
        samples_num=args.val_num, height=h, width=w,
    )
    g_path = next(
        (p for p in (os.path.join(args.run_dir, n) for n in WEIGHT_NAMES) if os.path.exists(p)),
        os.path.join(args.run_dir, WEIGHT_NAMES[0]),
    )
    trainer = Watermelon(
        filter_radius_coefficient=args.filter_radius_coefficient,
        pad_size=args.pad_size,
        distance_stack=np.linspace(-4e-4, 0.0, args.num_planes + 1)[:-1],
        pretrained_model_path_G=g_path,
        input_shape=(args.batch, 4, h, w),
        use_gan=False, perceptual="none", dtype=args.dtype,
        use_modulation=not args.no_modulation,
        cache_h=not args.no_cache_h,
        unet_base_features=args.unet_base_features,
        pad_cols_override=args.pad_cols,
        device=device,
    )
    trainer._init_state(seed=0, lr_G=1e-3, lr_D=1e-3)
    generator = trainer.state.generator.eval()
    gen_plan, multi_plan = trainer.gen_plan, trainer.multi_plan
    num_d = multi_plan.num_distances

    @torch.inference_mode()
    def recon_all(rgbd, amp, phs):
        """(B, D, 3, H, W) POH and target reconstructions of a batch."""
        rgbd, amp, phs = (torch.from_numpy(np.array(x, np.float32)).to(device) for x in (rgbd, amp, phs))
        poh = generator(gen_plan, rgbd)
        hat_freq = asm.propagate_poh2freq_forward(gen_plan, poh)
        tgt_freq = asm.filter_ap2filtered_freq(multi_plan, amp, phs)
        amps, _ = asm.freq2ap_all_distances(multi_plan, torch.cat([hat_freq, tgt_freq], dim=0),
                                            sequential=args.sequential)
        b = rgbd.shape[0]
        # (2B*D, 3, H, W), distance-major per sample -> (2B, D, 3, H, W)
        amps = amps.reshape(2 * b, num_d, *amps.shape[1:])
        return amps[:b], amps[b:]

    # ---- full-val metric sweep ----
    # SSIM's moment stack is 5 x planes x H x W float32: chunk the plane axis
    # so one chunk stays at ~0.4 GB (the batch's focal stacks stay resident)
    ssim_chunk = max(1, int(4e8 / (5 * 4 * h * w)))
    per_plane_psnr = np.zeros(num_d)
    tot_psnr = tot_ssim = 0.0
    n_batches = 0
    sweep_start = time.perf_counter()
    for start in range(0, args.val_num, args.batch):
        idx = range(start, min(start + args.batch, args.val_num))
        rgbd, amp, phs = (np.stack(x) for x in zip(*[val.get(i) for i in idx]))
        hat, tgt = recon_all(rgbd, amp, phs)
        with torch.inference_mode():
            tot_psnr += float(psnr(hat, tgt))
            tot_ssim += float(ssim(hat.reshape(-1, *hat.shape[2:]), tgt.reshape(-1, *tgt.shape[2:]),
                                   plane_chunk=ssim_chunk))
            for d in range(num_d):
                per_plane_psnr[d] += float(psnr(hat[:, d], tgt[:, d]))
        n_batches += 1
        del hat, tgt
        print(f"metrics {start + len(idx)}/{args.val_num}", flush=True)
    sweep_s = time.perf_counter() - sweep_start  # float() of each metric waited for the device
    summary = {
        "run_dir": args.run_dir,
        "val_PSNR": tot_psnr / n_batches,
        "val_SSIM": tot_ssim / n_batches,
        "per_plane_PSNR": (per_plane_psnr / n_batches).round(3).tolist(),
        "distances_m": multi_plan.distances.cpu().numpy().tolist(),
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in ("val_PSNR", "val_SSIM")}))
    print(f"metric sweep: {args.val_num} samples in {sweep_s:.3f} s, "
          f"{1e3 * sweep_s / args.val_num:.1f} ms/sample", flush=True)

    # ---- focal-stack grids for a few samples: far / middle / near planes ----
    planes = [0, num_d // 2, num_d - 1]
    for k in args.samples:
        rgbd, amp, phs = val.get(k)
        hat, tgt = recon_all(rgbd[None], amp[None], phs[None])
        path = os.path.join(out_dir, f"sample{k}_focalstack.png")
        _grid_png(path, rgbd, tgt[0].float().cpu().numpy(), hat[0].float().cpu().numpy(), planes)
        print(f"saved {path}")

    _curves(args.run_dir, out_dir)
    return dict(summary=summary, sweep_s=sweep_s)


if __name__ == "__main__":
    main()
