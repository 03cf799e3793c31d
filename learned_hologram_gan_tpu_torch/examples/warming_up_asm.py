#!/usr/bin/env python
"""Warming-up study: why the propagator is *band-limited* ASM (the port's
counterpart of ``examples/warming_up_asm.py``).

An executable version of the reference's notebook
(``warmingUp/aboutBandLimitedAngularSpectrumMethod.ipynb``), with
assertions, so that it both teaches and validates:

1. 1-D angular-spectrum propagation of a rect aperture at sampling interval
   dx = 2 lambda.
2. A finely sampled (64x or 512x oversampled window) AS evaluator as ground
   truth, free of the wrap-around aliasing the coarse grid suffers.
3. SNR of plain AS against distance: it collapses in the far field because
   the transfer function's phase exp(-2 pi i z w(f)) oscillates faster than
   the frequency grid can sample (Matsushima & Shimobaba 2009).
4. Band-limited AS: clipping |f| <= u_limit = 1/(lambda sqrt((2 du z)^2+1))
   recovers the far field.  Assert: SNR(band-limited) > SNR(plain) at long z.
5. The same effect in 2-D through the port's propagator (``ops/asm.py``,
   the band limit from ``ops/masks.py``): on the card its grid (256^2 with
   ``--quick``, else 512^2) runs K1.

The 1-D parts compute in float32, as the JAX example does::

    python -m learned_hologram_gan_tpu_torch.examples.warming_up_asm [--quick] [--plot] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch


def as_1d(wavelength: float, z: float, n: int = 2048, oversample: int = 1, band_limit: bool = False,
          device: str | torch.device = "cuda") -> np.ndarray:
    """Propagate a rect aperture distance z with (band-limited) ASM.

    ``oversample`` embeds the same physical aperture in an ``oversample``x
    wider zero-padded window, the evaluator trick: aliasing copies wrap
    around a window that much larger, so the central cut is exact.
    Returns the field magnitude on the original n-sample window."""
    dx = 2.0 * wavelength                      # Nyquist for |f| < 1/lambda
    big = n * oversample
    src = np.zeros(big, np.float32)
    lo = (big - n) // 2
    src[lo + n // 4: lo + 3 * n // 4] = 1.0   # the same aperture, a wider window

    # float32 throughout, Python scalars rounded to it as JAX rounds them:
    # fftfreq as the integer sequence times the f32 scale
    k = (np.fft.fftfreq(big) * big).astype(np.float32)
    f = torch.from_numpy(k * np.float32(1.0 / (big * dx))).to(device)
    w_sq = torch.clamp(1.0 / wavelength**2 - f * f, min=0.0)
    h = torch.polar(torch.ones_like(w_sq), (2.0 * math.pi * z) * torch.sqrt(w_sq))
    if band_limit:
        # Matsushima-Shimobaba limit for the *physical* window size n*dx
        du = 1.0 / (2.0 * n * dx)
        u_limit = 1.0 / (math.sqrt((2.0 * du * z) ** 2 + 1.0) * wavelength)
        h = torch.where(f.abs() <= u_limit, h, torch.zeros_like(h))
    g_z = torch.fft.ifft(torch.fft.fft(torch.from_numpy(src).to(device)) * h)
    return g_z.abs()[lo: lo + n].cpu().numpy()


def snr_db(truth: np.ndarray, approx: np.ndarray) -> float:
    p_sig = float(np.mean(truth.astype(np.float64) ** 2))
    p_noise = float(np.mean((approx.astype(np.float64) - truth) ** 2))
    return 10.0 * math.log10(p_sig / max(p_noise, 1e-30))


def compare_2d(z_factor: float = 100.0, n: int = 256, device: str | torch.device = "cuda") -> dict:
    """Square-aperture 2-D propagation through the port's plans, without and
    with the band limit folded into the plan's frequency mask; returns
    {False: plain, True: band-limited} (n, n) amplitudes."""
    from ..config import OpticsConfig
    from ..ops import asm, masks

    wavelength = 520e-9
    pitch = 2.0 * wavelength
    z = z_factor * n * pitch

    amp = np.zeros((1, 1, n, n), np.float32)
    amp[:, :, n // 4: 3 * n // 4, n // 4: 3 * n // 4] = 1.0
    amp = torch.from_numpy(amp).to(device)
    phs = torch.zeros_like(amp)

    cfg = OpticsConfig(rows=n, cols=n, pad_size=n // 2, pixel_pitch=pitch, wavelengths=(wavelength,),
                       filter_radius_coefficient=0.499)  # the aperture low-pass wide open
    plan = asm.make_plan(cfg, distances=np.array([z]), device=device)
    # the Matsushima mask (which the reference computes but never applies,
    # angular_spectrum_method.py:65-66) folded into the plan's mask
    bl = masks.band_limit_mask(cfg.padded_rows, cfg.padded_cols, pitch, (wavelength,), np.array([z]))[0, 0]
    plan_bl = plan.replace(mask=plan.mask * bl.to(plan.mask.device))
    outs = {}
    with torch.no_grad():
        for use_bl, p in ((False, plan), (True, plan_bl)):
            outs[use_bl] = asm.propagate_batch_multi(p, amp, phs)[0, 0].cpu().numpy()
    return outs


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the study; returns its figures: ``rows`` of (z in window sizes,
    SNR plain, SNR band-limited) and ``diff_2d``, the mean |band-limited -
    plain| of the 2-D far-field amplitudes."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="small grids for CI")
    ap.add_argument("--plot", action="store_true", help="write PNGs to examples/out/")
    ap.add_argument("--device", default="cuda", help="torch device to run on (cuda unless asked otherwise)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")

    wavelength = 1.0
    n = 512 if args.quick else 2048
    oversample = 64 if args.quick else 512
    s = n * 2.0 * wavelength

    # --- SNR against distance: plain vs band-limited, truth = oversampled window
    z_factors = [0.5, 10.0, 100.0, 400.0] if args.quick else [0.1, 0.5, 2, 10, 50, 100, 400]
    rows = []
    for n_s in z_factors:
        z = n_s * s
        truth = as_1d(wavelength, z, n, oversample=oversample, device=device)
        plain = as_1d(wavelength, z, n, device=device)
        limited = as_1d(wavelength, z, n, band_limit=True, device=device)
        rows.append((n_s, snr_db(truth, plain), snr_db(truth, limited)))
        print(f"z = {n_s:7.2f} S   SNR plain {rows[-1][1]:7.2f} dB   band-limited {rows[-1][2]:7.2f} dB")

    # near field: both fine; far field: band-limiting must win big
    far = rows[-1]
    assert far[2] > far[1] + 3.0, f"band-limited ASM should dominate in the far field: {far}"
    near = rows[0]
    assert near[1] > 20.0, f"plain ASM should be accurate in the near field: {near}"

    # --- 2-D through the port's propagator
    outs = compare_2d(n=128 if args.quick else 256, device=device)
    # without the limit the far-field pattern is polluted by wrap-around
    # copies that show up as high-frequency energy off the main lobe
    diff = float(np.mean(np.abs(outs[True] - outs[False])))
    print(f"2-D |band_limited - plain| mean: {diff:.4e} (the masked spectrum differs, as it must at far z)")
    assert diff > 0.0

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs("examples/out", exist_ok=True)
        zs = [r[0] for r in rows]
        fig, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
        a1.plot(zs, [r[1] for r in rows], "o-", label="plain AS")
        a1.plot(zs, [r[2] for r in rows], "s-", label="band-limited AS")
        a1.set_xscale("log")
        a1.set_xlabel("z [window sizes]")
        a1.set_ylabel("SNR vs oversampled truth [dB]")
        a1.legend()
        a2.imshow(np.concatenate([outs[False], outs[True]], axis=1), cmap="gray")
        a2.set_title("2-D recon: plain | band-limited")
        a2.axis("off")
        fig.tight_layout()
        fig.savefig("examples/out/warming_up_asm.png", dpi=120)
        print("wrote examples/out/warming_up_asm.png")

    print("warming-up ASM study: all assertions passed")
    return dict(rows=rows, diff_2d=diff)


if __name__ == "__main__":
    main()
