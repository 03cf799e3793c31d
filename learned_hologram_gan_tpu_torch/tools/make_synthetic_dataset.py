#!/usr/bin/env python
"""Physically consistent synthetic RGBD -> (amp, phs) dataset, MIT-CGH-4K
style (the port's counterpart of ``tools/make_synthetic_dataset.py``).

The scenes, their seeds, the layer depths and the ``.bin`` layout are the
JAX tool's; the per-layer spectra go through the port's ASM
(``ops/asm.py``), so on a card every 2-D FFT is kernel K3.  Per sample:

  1. a procedural RGBD scene (numpy, seeded per sample): a textured
     background and 4-8 textured objects at distinct depths, near occluding
     far;
  2. the depth map [0, 1] quantized into L layers on z in [z_far, z_near]
     (the span of the training distance stack);
  3. each layer's field ``img * e^{i phi0}`` propagated from its depth plane
     to the image plane by the plan's transfer function (layer k by -z_k),
     the fields summed in the spectrum (L forward FFTs, one inverse);
  4. the sum's |.| (normalized per sample and channel by 1.01 x its max)
     and its wrapped angle / 2 pi become (amp, phs).

Outputs raw float32 C-order bins (N, 3, H, W) under ``--out``:
``train/{img,depth,amp,phs}.bin`` and ``val/...``, plus a preview PNG of
sample 0 (RGB, depth, |target|, three refocused planes; one row of three
panels above the other, through ``utils/plotting.write_png``).  The flags
are the JAX tool's, plus ``--device`` (``cuda`` unless asked otherwise)::

    python -m learned_hologram_gan_tpu_torch.tools.make_synthetic_dataset \\
        --out data/synth384 --train_num 500 --val_num 100
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..config import OpticsConfig
from ..ops import asm
from ..utils.plotting import write_png

REF_WAVELENGTH = 638e-9  # phase heights are specified at the red wavelength


def _smooth_noise(rng: np.random.Generator, h: int, w: int, kmax: int) -> np.ndarray:
    """Sum of a few random low-frequency Fourier modes, roughly unit range."""
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    out = np.zeros((h, w), np.float32)
    for _ in range(6):
        fx, fy = rng.uniform(-kmax, kmax, 2)
        ph = rng.uniform(0, 2 * np.pi)
        out += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
    out -= out.min()
    return (out / max(out.max(), 1e-6)).astype(np.float32)


def _grating(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """High-frequency texture (random-orientation grating) in [0, 1]."""
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    f = rng.uniform(15.0, 60.0)
    th = rng.uniform(0, np.pi)
    ph = rng.uniform(0, 2 * np.pi)
    g = 0.5 + 0.5 * np.sin(2 * np.pi * f * (np.cos(th) * xx + np.sin(th) * yy) + ph)
    return g.astype(np.float32)


def make_scene(rng: np.random.Generator, h: int, w: int):
    """One RGBD sample: img (3, h, w) in [0.03, 1], depth (h, w) in [0, 1]."""
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    a, b = rng.uniform(-0.4, 0.4, 2)
    depth = 0.08 + 0.30 * np.clip(a * xx + b * yy + 0.5, 0, 1)
    depth += 0.08 * _smooth_noise(rng, h, w, 3)
    base = rng.uniform(0.15, 0.55, 3).astype(np.float32)
    tex = 0.65 + 0.35 * _grating(rng, h, w)
    noise = 0.85 + 0.15 * _smooth_noise(rng, h, w, 8)
    img = base[:, None, None] * tex[None] * noise[None]
    for _ in range(int(rng.integers(4, 9))):
        kind = rng.integers(0, 2)
        cx, cy = rng.uniform(0.12, 0.88, 2)
        if kind == 0:  # feathered disc
            r = rng.uniform(0.06, 0.2)
            dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            alpha = np.clip((r - dist) / (0.015 + 0.1 * r), 0, 1)
        else:  # rotated feathered rectangle
            th = rng.uniform(0, np.pi)
            u = np.cos(th) * (xx - cx) + np.sin(th) * (yy - cy)
            v = -np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy)
            ru, rv = rng.uniform(0.05, 0.22, 2)
            alpha = np.clip((ru - np.abs(u)) / 0.01, 0, 1) * np.clip((rv - np.abs(v)) / 0.01, 0, 1)
        obj_depth = float(rng.uniform(0.3, 1.0))
        color = rng.uniform(0.25, 1.0, 3).astype(np.float32)
        gr = 0.6 + 0.4 * _grating(rng, h, w)
        obj_rgb = color[:, None, None] * gr[None]
        sel = (alpha > 0.5) & (obj_depth > depth)  # near occludes far
        img = np.where(sel[None], obj_rgb, img)
        depth = np.where(sel, obj_depth, depth)
    img = np.clip(img, 0.03, 1.0).astype(np.float32)
    return img, np.clip(depth, 0.0, 1.0).astype(np.float32)


def build_synth_fn(optics: OpticsConfig, num_layers: int, z_near: float, z_far: float,
                   device: str | torch.device = "cuda"):
    """(img, depth, phs0) -> (amp, phs01) target-field synthesizer on
    ``device``, and the layer planes.  ``z_far < z_near < 0`` are offsets
    from the image plane; each layer is propagated by -z_k to the image
    plane, so that the training focal stack's z_k refocuses layer k."""
    z_planes = np.linspace(z_far, z_near, num_layers).astype(np.float32)
    plan = asm.make_plan(optics, distances=-z_planes, device=device, cache_h=True)
    wl = np.asarray(optics.wavelengths, np.float32)
    phase_scale = torch.from_numpy(REF_WAVELENGTH / wl).to(device)  # phi ~ 1/lambda

    @torch.no_grad()
    def synth(img: torch.Tensor, depth: torch.Tensor, phs0: torch.Tensor):
        # img (B, 3, H, W), depth (B, H, W) in [0, 1], phs0 (B, H, W) radians
        idx = torch.clamp((depth * num_layers).to(torch.int32), 0, num_layers - 1)
        onehot = F.one_hot(idx.long(), num_layers).permute(0, 3, 1, 2).to(img.dtype)  # (B, L, H, W)
        phi = phs0[:, None] * phase_scale[None, :, None, None]  # (B, 3, H, W)
        amp_layers = img[:, None] * onehot[:, :, None]  # (B, L, 3, H, W)
        g = asm.field(amp_layers, phi[:, None].expand_as(amp_layers))
        g0 = asm._fft2(asm.pad(plan, g))  # (B, L, 3, Rp, Cp)
        h_stack = asm._h_stack(plan)  # (L, 3, Rp, Cp): layer k's -z_k transfer function
        gz = torch.sum(g0 * (h_stack[None] * plan.mask), dim=1)  # (B, 3, Rp, Cp)
        out = asm.crop(plan, asm._ifft2(gz))
        amp = torch.abs(out)
        peak = torch.amax(amp, dim=(-2, -1), keepdim=True) * 1.01
        amp = amp / torch.clamp(peak, min=1e-6)
        ang = torch.atan2(out.imag, out.real)
        phs01 = torch.remainder(ang, 2.0 * np.pi) / (2.0 * np.pi)
        return amp, phs01

    return synth, z_planes


def generate_split(out_dir: str, n: int, h: int, w: int, synth, seed: int, batch: int = 4,
                   device: str | torch.device = "cuda") -> None:
    os.makedirs(out_dir, exist_ok=True)
    shape = (n, 3, h, w)
    files = {k: np.memmap(os.path.join(out_dir, f"{k}.bin"), dtype=np.float32, mode="w+", shape=shape)
             for k in ("img", "depth", "amp", "phs")}
    for start in range(0, n, batch):
        size = min(batch, n - start)
        imgs, depths, phs0s = [], [], []
        for i in range(size):
            rng = np.random.default_rng(seed + start + i)
            img, depth = make_scene(rng, h, w)
            imgs.append(img)
            depths.append(depth)
            phs0s.append(2.5 * _smooth_noise(rng, h, w, 5))
        amp, phs = synth(*(torch.from_numpy(np.stack(a)).to(device) for a in (imgs, depths, phs0s)))
        sl = slice(start, start + size)
        files["img"][sl] = np.stack(imgs)
        files["depth"][sl] = np.repeat(np.stack(depths)[:, None], 3, axis=1)  # loaders take channel 0
        files["amp"][sl] = amp.cpu().numpy()
        files["phs"][sl] = phs.cpu().numpy()
        if (start // batch) % 10 == 0:
            print(f"  {out_dir}: {start + size}/{n}")
    for f in files.values():
        f.flush()


def save_preview(out_dir: str, optics: OpticsConfig, png_path: str) -> None:
    """Sample-0 sanity grid: RGB, depth, |target| above three refocused
    planes, by numpy's FFT on the host (the JAX tool's preview math)."""
    h, w = optics.rows, optics.cols

    def first(name):
        return np.memmap(os.path.join(out_dir, f"{name}.bin"), np.float32, "r")[: 3 * h * w].reshape(3, h, w).copy()

    img, dep, amp, phs = (first(k) for k in ("img", "depth", "amp", "phs"))
    zs = np.asarray([-3.8e-4, -2.0e-4, -4.0e-5], np.float32)
    rp, cp = optics.padded_rows, optics.padded_cols
    pr, pc = optics.pad_rows, optics.pad_cols
    fx = asm._fftfreq_f32(rp, optics.pixel_pitch)[:, None]
    fy = asm._fftfreq_f32(cp, optics.pixel_pitch)[None, :]
    inv_wl_sq = 1.0 / np.asarray(optics.wavelengths, np.float32) ** 2
    w_grid = np.sqrt(np.clip(inv_wl_sq[:, None, None] - (fx * fx + fy * fy)[None], 0, None)).astype(np.float32)
    u = np.fft.fftfreq(rp).astype(np.float32)[:, None]
    v = np.fft.fftfreq(cp).astype(np.float32)[None, :]
    radial = np.sqrt(u * u + v * v) * min(rp, cp)
    mask = (radial <= min(rp, cp) * optics.filter_radius_coefficient).astype(np.float32)
    fpad = np.zeros((3, rp, cp), np.complex64)
    fpad[:, pr : pr + h, pc : pc + w] = amp * np.exp(2j * np.pi * phs)
    g0 = np.fft.fft2(fpad)
    recon = np.empty((len(zs), 3, h, w), np.float32)
    for i, z in enumerate(zs):
        recon[i] = np.abs(np.fft.ifft2(g0 * (np.exp(-2j * np.pi * z * w_grid) * mask))[:, pr : pr + h, pc : pc + w])
    recon /= max(recon.max(), 1e-6)
    panels = [img, np.repeat(dep[:1], 3, axis=0), amp / max(amp.max(), 1e-6)] + list(recon)
    rows = [np.concatenate(panels[k : k + 3], axis=2) for k in (0, 3)]
    grid = np.clip(np.concatenate(rows, axis=1), 0, 1).transpose(1, 2, 0)
    write_png(png_path, (grid * 255).astype(np.uint8))
    print(f"preview saved to {png_path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="data/synth384")
    ap.add_argument("--train_num", type=int, default=500)
    ap.add_argument("--val_num", type=int, default=100)
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--pad_size", type=int, default=320)
    ap.add_argument("--pad_cols", type=int, default=None,
                    help="column-pad override (4K: pick with utils/fftlen.good_fft_pads)")
    ap.add_argument("--filter_radius_coefficient", type=float, default=0.45)
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--z_far", type=float, default=-4e-4)
    ap.add_argument("--z_near", type=float, default=-2e-5)
    ap.add_argument("--seed", type=int, default=20260817)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--preview_only", action="store_true",
                    help="only (re)render the preview PNG from existing bins")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    optics = OpticsConfig(rows=args.rows, cols=args.cols, pad_size=args.pad_size,
                          filter_radius_coefficient=args.filter_radius_coefficient,
                          pad_cols_override=args.pad_cols)
    preview = (os.path.join(args.out, "train"), optics, os.path.join(args.out, "preview_train0.png"))
    if args.preview_only:
        save_preview(*preview)
        return
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    synth, z_planes = build_synth_fn(optics, args.layers, args.z_near, args.z_far, args.device)
    print(f"layer planes (m): {z_planes}")
    generate_split(os.path.join(args.out, "train"), args.train_num, args.rows, args.cols, synth,
                   args.seed, args.batch, args.device)
    generate_split(os.path.join(args.out, "val"), args.val_num, args.rows, args.cols, synth,
                   args.seed + 10_000_000, args.batch, args.device)
    save_preview(*preview)


if __name__ == "__main__":
    main()
